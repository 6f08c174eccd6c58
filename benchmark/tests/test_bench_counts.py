"""The yardstick's arithmetic at known shapes."""

import numpy as np
import pytest

from benchmark import roofline
from benchmark.manifest import metric_reader
from benchmark.ref import model as ref_model


def test_kernel3_counts_at_the_bench_batch():
    n, ci, h = 72704, 128, 1024
    nbytes, ops = roofline.kernel3_work(n, ci)
    assert ops == 2 * n * ci * h
    assert nbytes == 2 * (n * ci + ci * h + n // 8 * h) + 4 * (n + 2 * h)
    # the fused head's forward is bound by its products: 19.06 GFLOP at
    # 989 TFLOP/s is 0.0193 ms
    assert roofline.bound_s(nbytes, ops) == pytest.approx(ops / 989e12)
    assert roofline.bound_s(nbytes, ops) * 1e3 == pytest.approx(0.0193,
                                                                abs=5e-5)


def test_kernel11_counts_three_products():
    n, ci = 72704, 128
    b3, o3 = roofline.kernel3_work(n, ci)
    b11, o11 = roofline.kernel11_work(n, ci)
    assert o11 == 3 * o3
    assert b11 - b3 == 4 * n // 8 * 1024 + 4 * ci * 1024 + 2 * n * ci + 8 * 1024
    assert roofline.bound_s(b11, o11) * 1e3 == pytest.approx(0.0578, abs=5e-5)


def test_bound_takes_the_larger_side():
    assert roofline.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 989e12) == pytest.approx(1.0)


def test_model_flops_by_hand():
    # one data-input product (forward + weight gradient) and one inner one
    # (forward + both gradients)
    products = [("edges", 4, 8, True), ("nodes", 8, 2, False)]
    rows = {"edges": 10, "nodes": 3}
    assert roofline.model_flops(products, rows) == (
        2 * 10 * 4 * 8 * 2 + 2 * 3 * 8 * 2 * 3)


@pytest.mark.parametrize("arch", ["centernet3cc_rpn_gp_iter2", "yolat_pp"])
def test_products_cover_every_linear(arch):
    cfg = {"arch": arch, "n_filters": 64, "n_blocks": 2, "n_blocks_out": 2,
           "in_channels": 5, "n_classes": 17}
    prods = ref_model.products(cfg)
    weights = [s for s in ref_model.param_specs(cfg) if s[2] == "w"]
    assert len(prods) == len(weights)
    # the canonical step at the bench batch's real rows: the fusion MLP
    # over the nodes leads
    rows = {"nodes": 60000, "edges": 50000, "proposals": 3000,
            "super_edges": 300000}
    flops = roofline.model_flops(prods, rows)
    fusion = 2 * 60000 * 128 * 1024 * 3
    assert flops > fusion
    data_in = [p for p in prods if p[3]]
    assert len(data_in) == (4 if arch == "yolat_pp" else 3)
    if arch == "yolat_pp":
        assert ("super_edges", 132, 64, False) in prods


def test_real_rows_count_the_mask_and_its_blocks():
    mask = np.zeros(40, dtype=bool)
    mask[[0, 1, 9, 33]] = True          # blocks 0, 1 and 4 hold a real row
    assert roofline.real_rows(mask) == (4, 3)
    assert roofline.real_rows(np.ones(12, dtype=bool)) == (12, 2)


def test_kernel_roofline_bounds_the_real_rows():
    """The bound of a traced window counts each step's real rows and
    blocks, shared over the launches: the padding adds nothing."""
    cfg = {"n_filters": 64, "n_blocks_out": 2}
    rows = [(40000, 5100), (42000, 5300)]
    dev = [("block_max_tc_kernel", 0, 100000),
           ("bwd_rows_tc_kernel", 100000, 400000), ("other", 0, 10 ** 9)]
    rec = {"config": cfg, "trace": {
        "rows": rows, "dev": dev, "lo": 0, "hi": 10 ** 9,
        "launches": {"folded_mlp_block_max": 2, "fused_pool_train_bwd": 2}}}
    bound = sum(roofline.bound_s(*roofline.kernel3_work(n, 128, blocks=b))
                + roofline.bound_s(*roofline.kernel11_work(n, 128, blocks=b))
                for n, b in rows)
    got = metric_reader("kernel_roofline")(rec)
    assert got == pytest.approx(bound / 400e-6 * 100.0)
    padded = {**rec, "trace": {**rec["trace"],
                               "rows": [(72704, 9088), (72704, 9088)]}}
    assert metric_reader("kernel_roofline")(padded) > got
    # no launch of the kernels: nothing to read
    none = {**rec, "trace": {**rec["trace"], "launches": {}}}
    assert metric_reader("kernel_roofline")(none) is None
