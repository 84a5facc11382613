"""Serving export: the inference pipeline as a ``torch.export`` artifact.

Counterpart of ``retinex_tpu/infer/serving.py``. ``export_enhancer``
serialises the u8-in/u8-out enhance step, the signature the batched driver
runs (``infer/enhance.py::make_batch_pipeline``), with ``torch.export`` into
bytes that a serving host reloads with ``load_enhancer``, without the model
code, the checkpoint format or the CLI. The batch dimension is symbolic, so
one artifact serves any batch size; H and W are static (one artifact per
letterbox canvas).

Where the port's artifact parts from the JAX package's:

- The JAX artifact is StableHLO and needs only jax. The port's is an
  ``ExportedProgram``: it needs torch and the port's operator modules,
  ``ops/clahe_gather.py`` and ``ops/clahe_luma.py``, which register the
  kernels' wrappers as the operators ``retinex_tpu_torch::*`` that the
  program calls. On the card those launch the Lab-CLAHE kernels (K1-K3, in
  their tile modes where the canvas is not cell-divisible) and the luma
  kernels (K2, K7); on the CPU they run their plain versions. The JAX
  artifact runs the XLA route; the kernels are what the port's CLAHE is.
- It is exported on the device it serves on (``device``, where the JAX
  package takes ``platforms``): the weights and the route taken for the
  canvas are that device's.
- ``pipeline="enhance"`` serves the standard forward, as the JAX package
  does (``model.apply``, not the packed forward).
"""

from __future__ import annotations

import contextlib
import io

import torch

from retinex_tpu_torch.device import resolve_device

PIPELINES = ("enhance", "predict")
# The example batch that export traces: torch.export specialises sizes 0 and
# 1, so an example of 1 would fix the batch.
EXAMPLE_BATCH = 2
# The largest batch an artifact serves: exported on the card, PyTorch's CUDA
# operators guard the batch to a grid dimension's 65535 blocks, and export
# needs the symbol's range to admit that guard.
MAX_BATCH = 65535


class _U8Step(torch.nn.Module):
    """u8 NHWC batch -> the pipeline's u8 outputs: ``step(net, x)`` on the
    batch as float [0, 1], divided as ``make_batch_pipeline`` divides it.
    `net` (the model, or None) is a submodule, so its weights are the
    program's."""

    def __init__(self, step, net: torch.nn.Module | None = None):
        super().__init__()
        self.net = net
        self._step = step

    def forward(self, batch_u8: torch.Tensor):
        return self._step(self.net, batch_u8.to(torch.float32) / 255.0)


def make_serving_fn(model: torch.nn.Module, pipeline: str = "enhance") -> torch.nn.Module:
    """The u8 NHWC serving step of `model` (put in eval mode): batch_u8 ->
    (enhanced u8, illumination u8).

    ``"enhance"`` runs the standard forward and the adaptive Lab-CLAHE
    post-processing, as the batched driver's net mode does, so the served
    bytes are ``make_batch_pipeline``'s (floor quantisation, ``_quant``).
    ``"predict"`` serves the raw outputs, quantised, as ``--mode predict``
    writes them."""
    if pipeline not in PIPELINES:
        raise ValueError(f"pipeline must be 'enhance' or 'predict', got {pipeline!r}")
    from retinex_tpu_torch.infer.adaptive_params import AdaptiveParameterAdjuster
    from retinex_tpu_torch.infer.enhance import _quant

    def enhance(net, x):
        out, illu = AdaptiveParameterAdjuster().apply_adaptive_enhancement(net, x)
        return _quant(out), _quant(illu)

    def predict(net, x):
        enhanced, _refl, illu = net(x)
        return _quant(enhanced), _quant(illu)

    return _U8Step(enhance if pipeline == "enhance" else predict, model.eval())


def _export_u8(step: torch.nn.Module, height: int, width: int, path: str | None, device) -> bytes:
    """Shared export tail: the step on `device`, traced on a uint8 NHWC
    example with a symbolic batch, serialised (and written to `path`). One
    definition so that the net and classical exporters cannot drift."""
    dev = resolve_device(device)
    example = torch.zeros((EXAMPLE_BATCH, height, width, 3), dtype=torch.uint8, device=dev)
    program = torch.export.export(step.to(dev), (example,), dynamic_shapes=({0: torch.export.Dim("b", max=MAX_BATCH)},))
    program.example_inputs = None  # not saved: the example canvas would add H * W * 6 bytes of zeros
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def export_enhancer(
    model: torch.nn.Module,
    height: int,
    width: int,
    path: str | None = None,
    device: str | torch.device | None = None,
    pipeline: str = "enhance",
) -> bytes:
    """Serialise the serving step of `model` for a (height, width) canvas,
    symbolic batch, on `device` (the card unless ``"cpu"``; the model is
    moved there). Returns the bytes (also written to `path` when given)."""
    return _export_u8(make_serving_fn(model, pipeline), height, width, path, device)


def export_classical(
    mode: str,
    height: int,
    width: int,
    path: str | None = None,
    device: str | torch.device | None = None,
    clip_limit: float = 2.0,
    tiles: int = 8,
    hist_subsample: int = 1,
) -> bytes:
    """Serialise a no-net classical pipeline (ssr, msr, msrcr, clahe,
    clahe_luma) as a serving artifact: batch_u8 -> enhanced u8, symbolic
    batch, the float route of ``infer/enhance.py::_classical_enhance``
    quantised. `hist_subsample` is the decimated-histogram knob of clahe and
    clahe_luma (ssr, msr and msrcr ignore it)."""
    from retinex_tpu_torch.config import CLASSICAL_MODES
    from retinex_tpu_torch.infer.enhance import _classical_enhance, _quant

    if mode not in CLASSICAL_MODES:
        raise ValueError(f"mode must be one of {CLASSICAL_MODES}, got {mode!r}")

    def classical(_net, x):
        return _quant(_classical_enhance(x, mode, clip_limit, tiles, hist_subsample))

    return _export_u8(_U8Step(classical), height, width, path, device)


def load_program(path_or_bytes) -> torch.export.ExportedProgram:
    """The exported program of an artifact (a path or its bytes), after
    registering the operators it calls. Imports the operator modules only:
    no model code, CLI or checkpoint code."""
    import retinex_tpu_torch.ops.clahe_gather  # noqa: F401
    import retinex_tpu_torch.ops.clahe_luma  # noqa: F401

    src = io.BytesIO(bytes(path_or_bytes)) if isinstance(path_or_bytes, (bytes, bytearray)) else path_or_bytes
    return torch.export.load(src)


@contextlib.contextmanager
def exact_f32():
    """f32 computed in f32 on the card, as the CLI sets it: no TF32 in cuDNN
    or matmuls, bf16 matmuls summed in f32. The flags are process-wide and
    the artifact does not carry them, so they are set around each call and
    restored after it."""
    flags = (torch.backends.cudnn, "allow_tf32"), (torch.backends.cuda.matmul, "allow_tf32"), (
        torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction")
    saved = [getattr(obj, name) for obj, name in flags]
    try:
        for obj, name in flags:
            setattr(obj, name, False)
        yield
    finally:
        for (obj, name), value in zip(flags, saved):
            setattr(obj, name, value)


def load_enhancer(path_or_bytes):
    """Reload an artifact; returns fn(batch_u8) -> (enhanced u8, illu u8), or
    the enhanced u8 alone for a classical artifact. A batch of another canvas
    than the artifact's raises. Needs torch and the operator modules only
    (``load_program``)."""
    module = load_program(path_or_bytes).module()

    def served(batch_u8: torch.Tensor):
        with exact_f32(), torch.inference_mode():
            return module(batch_u8)

    return served
