"""Graft hooks: the flagship net's forward, and a multi-device dry run.

Counterpart of ``__graft_entry__.py``:

- ``entry()`` returns ``(forward, (example,))``, the eval-mode forward of
  MultiScaleUPRetinex with pre-activation blocks and ASPP (untrained
  weights, seed 0, as the JAX hook's ``PRNGKey(0)``) and a [1, 128, 128, 3]
  float input from numpy seed 0, both on the card unless ``device="cpu"``.
- ``dryrun_multichip(n)`` runs the data-parallel paths on `n` ranks or
  shards, at tiny shapes, and checks each: one full training step (the
  seven losses, the frequency loss included, and the clipped Adam update)
  and the packed step, each against the one-device step on the same global
  batch; a batch-sharded classical CLAHE and sharded inference, each byte
  for byte against one device; the spatially sharded forward (H split over
  the mesh, ``parallel/spatial.py``) within 2e-6 of the one-device forward,
  and the spatially sharded classical CLAHE byte for byte against one
  device (where the mesh divides the 8-tile grid, as the JAX hook). On the
  card the ranks take cards 0 to n-1 over NCCL where n cards are visible,
  else they all run on card 0 over gloo (NCCL takes one rank per GPU), the
  meshes likewise; with ``device="cpu"`` they run on the CPU over gloo.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from retinex_tpu_torch.device import resolve_device


def entry(device: str | torch.device | None = None):
    from retinex_tpu_torch.models.init import init_untrained
    from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex

    dev = resolve_device(device)
    model = init_untrained(MultiScaleUPRetinex(use_preact=True, use_aspp=True), 0).eval().to(dev)

    def forward(batch: torch.Tensor):
        with torch.inference_mode():
            return model(batch)

    example = np.random.default_rng(0).random((1, 128, 128, 3)).astype(np.float32)
    return forward, (torch.from_numpy(example).to(dev),)


def _dryrun_mesh(n: int, device: str | torch.device | None):
    """(mesh, the ranks' device, backend) of the dry run: n cards over NCCL
    where they are visible; else every rank and shard on card 0 over gloo
    (NCCL takes one rank per GPU); or the CPU over gloo."""
    from retinex_tpu_torch.parallel.mesh import Mesh, create_mesh

    dev = resolve_device(device)
    if dev.type == "cpu":
        return create_mesh(n, "cpu"), "cpu", "gloo"
    visible = torch.cuda.device_count()
    if n <= visible:
        return create_mesh(n), "cuda", "nccl"
    return Mesh((torch.device("cuda", 0),) * n), "cuda:0", "gloo"


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None) -> None:
    from retinex_tpu_torch.infer.batch_driver import fetch, shard_batch_fn
    from retinex_tpu_torch.losses.total import LossConfig
    from retinex_tpu_torch.models.init import init_untrained
    from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
    from retinex_tpu_torch.ops.clahe import clahe_lab_rgb
    from retinex_tpu_torch.train.data_parallel import StepSpec, one_step, sharded_steps

    n = n_devices
    mesh, rank_dev, backend = _dryrun_mesh(n, device)
    assert mesh.size == n, (mesh.size, n)
    print(f"dryrun_multichip({n}): {n} ranks on {', '.join(str(d) for d in mesh.devices)} over {backend}")

    losses = LossConfig(use_freq_loss=True, use_perceptual_loss=True)
    specs = [StepSpec(use_preact=True, use_aspp=True, lr=1e-4, loss=losses, packed=p) for p in (False, True)]
    batch = np.random.default_rng(0).random((2 * n, 32, 32, 3)).astype(np.float32)
    one_dev = mesh.devices[0]
    standard, packed = sharded_steps(n, specs, batch, device=rank_dev, backend=backend)
    total = standard["loss"]["total"]
    assert np.isfinite(total), total
    want = one_step(specs[0], batch, one_dev)["loss"]["total"]
    assert abs(total - want) <= 1e-4 * abs(want), (total, want)
    print(f"dryrun_multichip({n}): ok, total loss {total:.4f} (one device {want:.4f})")

    total_pk = packed["loss"]["total"]
    assert np.isfinite(total_pk), total_pk
    assert abs(total_pk - total) < 1e-3 * max(1.0, abs(total)), (total_pk, total)
    print(f"dryrun_multichip({n}): packed train step ok, total loss {total_pk:.4f} (standard {total:.4f})")

    frames = np.random.default_rng(3).random((2 * n, 64, 64, 3)).astype(np.float32)
    sharded = fetch(shard_batch_fn(clahe_lab_rgb, mesh)(frames), 2 * n)
    single = clahe_lab_rgb(torch.from_numpy(frames).to(one_dev)).cpu().numpy()
    np.testing.assert_array_equal(sharded, single)
    print(f"dryrun_multichip({n}): sharded classical CLAHE ok (byte-identical)")

    model = init_untrained(MultiScaleUPRetinex(use_preact=True, use_aspp=True), 0).eval()
    copies = {d: copy.deepcopy(model).to(d) for d in dict.fromkeys(mesh.devices)}

    def infer_fn(batch_u8: torch.Tensor):
        x = batch_u8.to(torch.float32) / 255.0
        with torch.inference_mode():
            enhanced, _refl, illu = copies[x.device](x)
        q = lambda v: torch.clamp(torch.round(v * 255.0), 0, 255).to(torch.uint8)  # noqa: E731
        return q(enhanced), q(illu)

    chunk = np.random.default_rng(1).integers(0, 256, (2 * n, 32, 32, 3), dtype=np.uint8)
    enh_sharded, _ = fetch(shard_batch_fn(infer_fn, mesh)(chunk), 2 * n)
    enh_single, _ = fetch(infer_fn(torch.from_numpy(chunk).to(one_dev)), 2 * n)
    np.testing.assert_array_equal(enh_sharded, enh_single)
    print(f"dryrun_multichip({n}): sharded inference ok (byte-identical)")

    from retinex_tpu_torch.parallel.spatial import gather_rows, make_spatial_clahe, make_spatial_forward, shard_rows

    h = 8 * n * 2  # two 8-row-aligned slabs per device
    frame = torch.from_numpy(np.random.default_rng(2).random((1, h, 32, 3)).astype(np.float32))
    out = make_spatial_forward(copies[one_dev], mesh)(shard_rows(frame, mesh))
    with torch.inference_mode():
        ref = copies[one_dev](frame.to(one_dev))
    for name, a, b in zip(["enhanced", "reflectance", "illu"], out, ref):
        a = gather_rows(a, "cpu").numpy()
        assert np.isfinite(a).all(), f"spatial {name}: non-finite"
        np.testing.assert_allclose(a, b.cpu().numpy(), atol=2e-6, err_msg=f"spatial {name}")
    print(f"dryrun_multichip({n}): spatial-sharded forward ok")

    if 8 % n == 0:
        frame = torch.from_numpy(np.random.default_rng(4).random((1, 128, 64, 3)).astype(np.float32))
        out_sp = gather_rows(make_spatial_clahe(mesh)(shard_rows(frame, mesh)), "cpu")
        np.testing.assert_array_equal(out_sp.numpy(), clahe_lab_rgb(frame.to(one_dev)).cpu().numpy())
        print(f"dryrun_multichip({n}): spatial-sharded classical CLAHE ok (byte-identical)")
    else:
        print(f"dryrun_multichip({n}): spatial CLAHE skipped (mesh {n} does not divide the 8-tile grid)")
