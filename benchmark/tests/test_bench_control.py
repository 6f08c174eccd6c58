"""The control on the card: the reference put in the program's place with
its products at float8, one step below the configurations' bf16, comes
out not correct under each cell's limits, on three seeds. At a small size
(8 floorplans of 800x600, 16 channels); the readings at the cells' own
size are `python3 -m benchmark.control` (PERF.md)."""

import pytest

from benchmark import check, manifest
from benchmark.control import readings_for
from benchmark.tests.conftest import make_tiny_root


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["yolat_train", "yolatpp_train"])
def test_fp8_control_is_not_correct(tmp_path, name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = make_tiny_root(str(tmp_path), dtype="bfloat16")
    cell = manifest.load_cell(name, root=root)
    lines = readings_for(cell, [11, 12, 13], ["fp8"], "cuda")
    limits = manifest.load_cell(name).config["limits"]
    assert len(lines) == 3
    for line in lines:
        assert not check.judge(line, limits), line
