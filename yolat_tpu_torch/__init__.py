"""yolat_tpu_torch — the PyTorch + CUDA port of `yolat_tpu` for one NVIDIA H100.

The JAX package `yolat_tpu/` is the reference this port is held against;
this package imports `torch`, numpy and scipy, never `jax` and nothing of
`yolat_tpu`. Its layout mirrors the reference package:

  config  the serving and training fields of the reference Config
  geom/   host stage: SVG parsing, graph build, proposal generation (numpy)
  data/   synthetic SESYD-style documents, the cached SESYDDataset,
          CompactFile / pack_files / finalize_batch (with the train-time
          augmentation) and a packed loader with the shuffled epoch order
  ops/    numpy pack-time plans, torch segment ops with the JAX package's
          gradients / IoU / NMS, the fused training pool head, and four
          hand-written Hopper kernels (edge-window message sum, fusion-MLP
          block max in its serving and training forms, the training pool
          head's backward) with their plain PyTorch versions
  nn/     the canonical SparseCADGCN (train and eval) and its loss, named
          like the reference state dict so a reference `.pth` loads
          directly, and the JAX-variables -> reference state-dict
          conversion
  train/  optimizers, the train step (f32, or bf16 over f32 master
          weights), torch.save checkpoints and the trainer
  eval/   folded-BN serving engine, the predict core (kept mask,
          inflation, slot scatter, fixpoint NMS), the evaluation runner
          and the reference's metrics
  parallel/ data parallelism, one process per device: the run's ranks
          (NCCL on the card, gloo on the CPU), the store barrier, the
          batch moments summed over ranks, the launcher, graph partitions
  utils/  experiment directories, logging, meters
  cli/    `python -m yolat_tpu_torch.cli.infer`, `.cli.train`, `.cli.profile`
  csrc/   CUDA C++ sources for sm_90a, built by nvcc at first use

Kernels run on CUDA tensors; CPU tensors take each kernel's plain version.
"""

__version__ = "0.1.0"
