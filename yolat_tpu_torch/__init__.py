"""yolat_tpu_torch — the PyTorch + CUDA port of `yolat_tpu` for one NVIDIA H100.

The JAX package `yolat_tpu/` is the reference this port is held against;
this package imports `torch`, numpy and scipy, never `jax` and nothing of
`yolat_tpu`. Its layout mirrors the reference package:

  config  the serving fields of the reference Config
  geom/   host stage: SVG parsing, graph build, proposal generation (numpy)
  data/   synthetic SESYD-style documents, the cached SESYDDataset,
          CompactFile / pack_files / eval finalize_batch and a sequential
          packed loader
  ops/    numpy pack-time plans, torch segment ops / IoU / NMS, and the two
          hand-written Hopper kernels (edge-window message sum, fused
          fusion-MLP block max) with their plain PyTorch versions
  nn/     the canonical SparseCADGCN eval forward, named like the
          reference state dict so a reference `.pth` loads directly, and
          the JAX-variables -> reference state-dict conversion
  eval/   folded-BN serving engine and the predict core (kept mask,
          inflation, slot scatter, fixpoint NMS)
  cli/    `python -m yolat_tpu_torch.cli.infer`
  csrc/   CUDA C++ sources for sm_90a, built by nvcc at first use

Kernels run on CUDA tensors; CPU tensors take each kernel's plain version.
"""

__version__ = "0.1.0"
