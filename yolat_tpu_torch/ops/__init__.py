"""Pack-time plans, torch segment ops / IoU / NMS, and the hand-written CUDA kernels with their plain PyTorch versions."""
