"""retinex_tpu_torch: the PyTorch/CUDA port of retinex_tpu.

It runs beside the JAX package and imports nothing of it (nor JAX):

- ``retinex_tpu_torch.ops``    — colour, resize, letterbox and Lab-CLAHE; the
  CLAHE kernels (``ops/clahe_gather.py``) are hand-written CUDA for Hopper
  (``csrc/clahe_lab.cu``), each with its plain PyTorch version beside it.
- ``retinex_tpu_torch.models`` — MultiScaleUPRetinex as NCHW ``nn.Module``s
  with the reference checkpoint names, and the Flax -> PyTorch weight
  converter.
- ``retinex_tpu_torch.infer``  — the adaptive enhance route (net + Lab-CLAHE).
- ``retinex_tpu_torch.cli``    — ``--mode enhance`` on one image.
- ``retinex_tpu_torch.parallel`` — the data mesh of sharded directory runs
  and the process groups of multi-device and multi-host training.

Public functions take the JAX package's layouts (float [0,1] HWC/NHWC
images). Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
