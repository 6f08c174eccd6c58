"""The yardstick's arithmetic: the card's peaks, the bytes and operations
of the port's kernels, and the model's products per step.

Peaks: NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit.
The kernel counts are copies of the program's chip_smoke.py (kernel 3,
`folded_mlp_block_max`, and kernel 11, `fused_pool_train_bwd`; its
`bound`) at commit 8dc2b5b: each input byte read once and each output
byte written once, and the products the function needs (kernel 11: three
of the forward's size).
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12      # HBM3, bytes/s
PEAK_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
POOL_BLOCK = 8            # rows per block maximum of the pool head
FUSION = 1024


def bound_s(nbytes: float, ops: float, peak_ops: float = PEAK_BF16) -> float:
    """The least time the card could take: bytes over the memory rate or
    operations over their peak rate, whichever is larger."""
    return max(nbytes / PEAK_BYTES, ops / peak_ops)


def kernel3_work(n: int, ci: int, h: int = FUSION,
                 blocks: int | None = None) -> tuple:
    """(bytes, operations) of one bf16 call of kernel 3 over n node rows of
    ci channels into h: x, W and the block maxima, the mask and the
    scale/shift. `blocks`: the 8-row blocks whose maxima are written
    (n // 8 where every row is counted)."""
    blocks = n // POOL_BLOCK if blocks is None else blocks
    return (2 * (n * ci + ci * h + blocks * h) + 4 * (n + 2 * h),
            2 * n * ci * h)


def kernel11_work(n: int, ci: int, h: int = FUSION,
                  blocks: int | None = None) -> tuple:
    """(bytes, operations) of one bf16 call of kernel 11: kernel 3's inputs
    and the pooled maxima's cotangent in; dW, dx and two column sums out;
    three products of the forward's size (z to find the winners, dW, dx)."""
    blocks = n // POOL_BLOCK if blocks is None else blocks
    b3, _ = kernel3_work(n, ci, h, blocks)
    return (b3 + 4 * blocks * h + 4 * ci * h + 2 * n * ci + 8 * h,
            3 * 2 * n * ci * h)


def real_rows(node_mask) -> tuple:
    """(rows, blocks) of a batch that the fused head's kernels must touch:
    the real node rows (`node_mask`) and the 8-row blocks that hold one.
    The masked-out rows are padding whose maxima the head discards, so the
    least work of a launch counts none of them."""
    import numpy as np

    m = np.asarray(node_mask, dtype=bool)
    pad = -len(m) % POOL_BLOCK
    blocks = np.pad(m, (0, pad)).reshape(-1, POOL_BLOCK).any(axis=1)
    return int(np.count_nonzero(m)), int(np.count_nonzero(blocks))


# the port's kernels whose roofline the benchmark reads: its launch
# counter (`ops._build.launch_counts`), the substrings of its device
# records' names, and its (bytes, operations) per launch from a batch's
# real node rows and blocks (`real_rows`) and the config
KERNELS = {
    "folded_mlp_block_max": {
        "names": ("block_max_tc_kernel", "block_max_kernel"),
        "work": lambda n, blocks, cfg: kernel3_work(
            n, cfg["n_filters"] * cfg["n_blocks_out"], blocks=blocks)},
    "fused_pool_train_bwd": {
        "names": ("bwd_rows_tc_kernel", "bwd_dw_tc_kernel", "bwd_rows_kernel",
                  "bwd_dw_kernel", "sum_parts_kernel"),
        "work": lambda n, blocks, cfg: kernel11_work(
            n, cfg["n_filters"] * cfg["n_blocks_out"], blocks=blocks)},
}


def model_flops(products: list, rows: dict) -> float:
    """The model's FLOPs in one train step: every product forward (2 r ci
    co) and backward (the weights' gradient, and the input's where the
    input is not data), over the real rows of its population.
    `products`: (population, ci, co, input_is_data) per Linear
    (`ref.model.products`); `rows`: real rows per population."""
    total = 0.0
    for pop, ci, co, data_in in products:
        total += 2.0 * rows[pop] * ci * co * (2 if data_in else 3)
    return total
