"""The serving routes' kernel wrappers as PyTorch operators, the exported
graph, a serving process without the model code, the export script and the
driver hook (retinex_tpu_torch/graft_entry.py), on the CPU.

- The six wrappers of K1-K3 and K7 that the serving routes call are the
  operators ``retinex_tpu_torch::*`` and pass ``torch.library.opcheck``
  (schema, fake implementation, autograd registration, AOT dispatch).
- At the cell-divisible 64x96 canvas the enhance and clahe artifacts' graphs
  call the three Lab-CLAHE operators (K1, K2, K3), clahe_luma's K2's and
  K7's: on the card these launch the kernels. (A canvas that is not
  cell-divisible takes the plain clahe_u8 on the CPU, as the JAX package
  routes it; the tile-mode operators are shown on the card, chip_smoke.py
  phase 22.)
- A fresh process that imports only ``retinex_tpu_torch.infer.serving``
  loads an artifact and serves it, without ``retinex_tpu_torch.models``.
- ``graft_entry.entry()`` on the CPU equals the JAX forward on the same
  weights within tests/test_torch_model.py's atol.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.models import MultiScaleUPRetinex as JaxNet
from retinex_tpu_torch import graft_entry
from retinex_tpu_torch.cli import init_untrained
from retinex_tpu_torch.infer import serving
from retinex_tpu_torch.infer.enhance import _quant
from retinex_tpu_torch.models.convert import state_dict_to_variables
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
from retinex_tpu_torch.ops import clahe_gather as cg
from retinex_tpu_torch.ops import clahe_luma as cl
from retinex_tpu_torch.scripts import export_serving

REPO = Path(__file__).resolve().parent.parent
H, W = 64, 96
OPS = torch.ops.retinex_tpu_torch
LAB_CLAHE = {OPS.lab_fwd_f32_nhwc.default, OPS.clahe_tables.default, OPS.clahe_apply_f32_nhwc.default}
LUMA = {OPS.clahe_tables.default, OPS.clahe_luma_apply_u8.default}


@pytest.fixture(scope="module")
def port_net():
    return init_untrained(MultiScaleUPRetinex(use_preact=False, use_aspp=False), 0).eval()


# The operator of each case, then how the case calls it.
OPERATOR_CASES = {
    "lab_fwd_f32_nhwc": "lab_fwd_f32_nhwc",
    "clahe_tables": "clahe_tables",
    "clahe_tables_plane": "clahe_tables",
    "clahe_apply_f32_nhwc": "clahe_apply_f32_nhwc",
    "clahe_tables_tiles": "clahe_tables_tiles",
    "clahe_apply_tiles_f32_nhwc": "clahe_apply_tiles_f32_nhwc",
    "clahe_luma_apply_u8": "clahe_luma_apply_u8",
    "clahe_luma_apply_u8_planar": "clahe_luma_apply_u8",
}


def _operator_args(case: str) -> tuple:
    """Small CPU inputs of each case: every wrapper at a cell-divisible frame
    (the tile modes at a ragged one), K2 on planar Lab and on a plane, K7 on
    NHWC and planar RGB."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand((2, 32, 48, 3), generator=g)
    lab = cg.lab_fwd_f32_nhwc_plain(x)
    ragged = cg.lab_fwd_f32_nhwc_plain(torch.rand((2, 30, 41, 3), generator=g))
    rgb = torch.randint(0, 256, (2, 32, 48, 3), dtype=torch.uint8, generator=g)
    y = cl._luma_u8(rgb, dim=3)
    return {
        "lab_fwd_f32_nhwc": (x,),
        "clahe_tables": (lab, 2.0, 4, 4, 1),
        "clahe_tables_plane": (y, 3.0, 4, 4, 2),
        "clahe_apply_f32_nhwc": (lab, cg.clahe_tables_plain(lab, 2.0, 4, 4)),
        "clahe_tables_tiles": (ragged, 2.0, 4, 4),
        "clahe_apply_tiles_f32_nhwc": (ragged, cg.clahe_tables_tiles_plain(ragged, 2.0, 4, 4)),
        "clahe_luma_apply_u8": (rgb, y, cg.clahe_tables_plain(y, 2.0, 4, 4)),
        "clahe_luma_apply_u8_planar": (rgb.permute(0, 3, 1, 2).contiguous(), y, cg.clahe_tables_plain(y, 2.0, 4, 4)),
    }[case]


@pytest.mark.parametrize("case", list(OPERATOR_CASES))
def test_operator_passes_opcheck(case):
    """The wrapper is the registered operator (the same outputs through
    torch.ops), and its fake implementation, schema and registrations pass
    opcheck, the fake's shape, dtype and strides the real output's."""
    name = OPERATOR_CASES[case]
    wrapper = getattr(cl if name.startswith("clahe_luma") else cg, name)
    args = _operator_args(case)
    got = wrapper(*args)
    assert torch.equal(getattr(OPS, name).default(*args), got)
    torch.library.opcheck(wrapper, args)


@pytest.mark.parametrize("key", ["enhance", "clahe", "clahe_luma"])
def test_exported_graph_calls_the_kernel_operators(port_net, key):
    if key == "enhance":
        blob = serving.export_enhancer(port_net, H, W, device="cpu")
    else:
        blob = serving.export_classical(key, H, W, device="cpu")
    graph = serving.load_program(blob).graph
    targets = {n.target for n in graph.nodes if n.op == "call_function"}
    ours = {t for t in targets if str(t).startswith("retinex_tpu_torch.")}
    assert ours == (LUMA if key == "clahe_luma" else LAB_CLAHE)


_SERVER = """
import json, sys
import numpy as np, torch
from retinex_tpu_torch.infer import serving
fn = serving.load_enhancer(sys.argv[1])
x = torch.from_numpy(np.load(sys.argv[2]))
enh, illu = fn(x)
np.savez(sys.argv[3], enhanced=enh.numpy(), illumination=illu.numpy())
print(json.dumps(sorted(m for m in sys.modules if m.startswith(("retinex_tpu", "jax")))))
"""


def test_a_fresh_process_serves_without_the_model_code(port_net, tmp_path):
    path = tmp_path / "enhance_64x96.pt2"
    serving.export_enhancer(port_net, H, W, path=str(path), device="cpu")
    x = np.random.default_rng(3).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    np.save(tmp_path / "x.npy", x)
    proc = subprocess.run(
        [sys.executable, "-c", _SERVER, str(path), str(tmp_path / "x.npy"), str(tmp_path / "out.npz")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    modules = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not [m for m in modules if m.startswith(("retinex_tpu_torch.models", "retinex_tpu_torch.cli", "jax"))]
    assert not [m for m in modules if m == "retinex_tpu" or m.startswith("retinex_tpu.")]
    assert "retinex_tpu_torch.ops.clahe_gather" in modules
    enh, illu = serving.load_enhancer(str(path))(torch.from_numpy(x))
    out = np.load(tmp_path / "out.npz")
    np.testing.assert_array_equal(out["enhanced"], enh.numpy())
    np.testing.assert_array_equal(out["illumination"], illu.numpy())


def test_export_script_takes_a_pth_checkpoint(port_net, tmp_path, capsys):
    ckpt = tmp_path / "model.pth"
    torch.save({"epoch": 3, "model_state_dict": port_net.state_dict()}, ckpt)
    out = tmp_path / "predict_64x96.pt2"
    blob = export_serving.main([
        "--checkpoint", str(ckpt), "--height", str(H), "--width", str(W), "--out", str(out),
        "--pipeline", "predict", "--device", "cpu",
    ])
    assert out.read_bytes() == blob
    assert f"canvas {H}x{W}, predict pipeline" in capsys.readouterr().out
    x = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, H, W, 3), dtype=np.uint8))
    enh, illu = serving.load_enhancer(str(out))(x)
    with torch.inference_mode():
        want_enh, _refl, want_illu = port_net(x.to(torch.float32) / 255.0)
    assert torch.equal(enh, _quant(want_enh)) and torch.equal(illu, _quant(want_illu))


def test_export_script_rejects_orbax_and_missing_checkpoints(tmp_path):
    args = ["--height", str(H), "--width", str(W), "--out", str(tmp_path / "a.pt2"), "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="Orbax"):
        export_serving.main(["--checkpoint", str(tmp_path), *args])
    with pytest.raises(FileNotFoundError):
        export_serving.main(["--checkpoint", str(tmp_path / "missing.pth"), *args])


def test_export_on_the_card_without_one_raises(port_net):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.export_enhancer(port_net, H, W, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


def test_graft_entry_matches_the_jax_forward():
    forward, (example,) = graft_entry.entry(device="cpu")
    assert example.shape == (1, 128, 128, 3) and example.dtype == torch.float32
    np.testing.assert_array_equal(example.numpy(), np.random.default_rng(0).random((1, 128, 128, 3)).astype(np.float32))
    got = [t.numpy() for t in forward(example)]
    port = init_untrained(MultiScaleUPRetinex(use_preact=True, use_aspp=True), 0)
    variables = state_dict_to_variables(port.state_dict(), use_aspp=True)
    want = JaxNet(use_preact=True, use_aspp=True).apply(variables, jnp.asarray(example.numpy()), train=False)
    for name, g, w, atol in zip(("enhanced", "reflectance", "illumination"), got, want, (2e-3, 2e-3, 2e-5)):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, err_msg=name)


def test_served_calls_run_without_tf32():
    """The artifact does not carry the process-wide TF32 flags: each served
    call turns them off, as the CLI does, and restores them after."""
    flags = (torch.backends.cudnn, "allow_tf32"), (torch.backends.cuda.matmul, "allow_tf32"), (
        torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction")
    saved = [getattr(obj, name) for obj, name in flags]
    try:
        for obj, name in flags:
            setattr(obj, name, True)
        with serving.exact_f32():
            assert not any(getattr(obj, name) for obj, name in flags)
        served = serving.load_enhancer(serving.export_classical("ssr", H, W, device="cpu"))
        served(torch.zeros((1, H, W, 3), dtype=torch.uint8))
        assert all(getattr(obj, name) for obj, name in flags)
    finally:
        for (obj, name), value in zip(flags, saved):
            setattr(obj, name, value)
