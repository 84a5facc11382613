"""Operations and bytes of the port's kernels on the enhance routes, from
the cell's shapes.

Each kernel is counted by the function it computes, whatever implements
it: every input read once, every output written once, f32 (4 bytes), and
the operations of the standard layers it stands for (2 x multiply-adds of
their convolutions; the elementwise products of the attention tails).
Lab-CLAHE's kernels are counted by their bytes alone. A kernel's bound is
the larger of its bytes over the HBM bandwidth and its operations over the
f32 peak (``counts/peaks.py``).

The FAM kernels run on the scale-1 FAM (the frame's size) and the scale-2
FAM (a quarter of it on each side: the tower's half-size input, max-pooled
by 2); K6 where the tower's fusion folds (H and W multiples of 16), else
K11.
"""

from __future__ import annotations

from portbench.counts import peaks

F32 = 4
FAM = 32
TILES = 8
# 2 x the multiply-adds per pixel of the FAM's conv stage: branch1 and
# branch2's 1x1s, the four 3x3s of branches 3 and 4, the 128 -> 32 fusion.
FAM_CONV_MACS = 2 * FAM * FAM + 4 * 9 * FAM * FAM + 4 * FAM * FAM

# Kernel families: the substring of the device trace's names that times
# them, and the one whose launches count the family's calls.
NAMES = {
    "K1": (("lab_fwd_kernel",), "lab_fwd_kernel"),
    "K2": (("clahe_tables_kernel",), "clahe_tables_kernel"),
    "K3": (("clahe_apply_kernel",), "clahe_apply_kernel"),
    "K4": (("conv_pipelined_f32_kernel", "fam_conv_out_kernel"), "fam_conv_out_kernel"),
    "K5": (("fam_tail_stats_kernel",), "fam_tail_stats_kernel"),
    "K6": (("fam_tail_apply_g1_kernel",), "fam_tail_apply_g1_kernel"),
    "K11": (("fam_tail_apply_kernel",), "fam_tail_apply_kernel"),
}


def fam_pixels(h: int, w: int) -> list[int]:
    """Pixels of the two FAMs on the kernels: scale 1 and scale 2."""
    return [h * w, ((h // 2) // 2) * ((w // 2) // 2)]


def forward_work(batch: int, h: int, w: int) -> dict[str, tuple[int, float, float]]:
    """Kernel family -> (calls, bytes, operations) of one forward call of
    the default route (packed net, then Lab-CLAHE) on a [batch, h, w] frame."""
    px = [batch * n for n in fam_pixels(h, w)]
    tail = "K6" if h % 16 == 0 and w % 16 == 0 else "K11"
    frame = batch * h * w
    luts = batch * TILES * TILES * 256
    work = {
        "K4": (2, sum(p * 2 * FAM * F32 for p in px), sum(p * 2 * FAM_CONV_MACS for p in px)),
        "K5": (2, sum(p * (FAM + 2) * F32 for p in px), sum(p * 3 * FAM for p in px)),
        tail: (2, sum(p * (2 * FAM + 1) * F32 for p in px),
               sum(p * (2 * FAM + (2 * FAM * FAM if tail == "K6" else 0)) for p in px)),
        "K1": (1, frame * (3 * F32 + 3), 0),
        "K2": (1, frame + luts, 0),
        "K3": (1, frame * (3 + 3 * F32) + luts, 0),
    }
    return work


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.F32_FLOPS)


def roofline_pct(device_ops: dict[str, tuple[int, float]], batch: int, h: int, w: int) -> float | None:
    """The kernels' share of their bounds over the traced window: the sum of
    each family's bound for the calls the trace shows over the sum of their
    device seconds, in %. `device_ops`: device op name -> (launches,
    seconds). None where no family ran."""
    total_bound, total_time = 0.0, 0.0
    for fam, (calls, nbytes, ops) in forward_work(batch, h, w).items():
        subs, counter = NAMES[fam]
        seconds = sum(s for name, (_n, s) in device_ops.items() if any(sub in name for sub in subs))
        launched = sum(n for name, (n, _s) in device_ops.items() if counter in name)
        if launched == 0 or seconds <= 0:
            continue
        total_bound += launched / calls * bound_s(nbytes, ops)
        total_time += seconds
    if total_time <= 0:
        return None
    return 100.0 * total_bound / total_time
