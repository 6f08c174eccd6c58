"""`ScalarWriter`'s TensorBoard sink (where tensorboard is installed): the
scalars of its event file equal its JSON lines, tag for tag and step for
step (values as float32, the event file's type), after `flush` and after
`close`. In a file of its own: importing `torch.utils.tensorboard` imports
TensorFlow where that is installed, some 15-20 s.
"""

import glob
import json
import os
import struct

import numpy as np
import pytest

from yolat_tpu_torch.utils.experiment import ScalarWriter

pytest.importorskip("tensorboard")


def _events(path: str) -> list:
    """(tag, step, value) of every scalar in a TFRecord event file."""
    from tensorboard.compat.proto import event_pb2

    out = []
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        (n,) = struct.unpack("<Q", data[i:i + 8])
        ev = event_pb2.Event.FromString(data[i + 12:i + 12 + n])
        i += 12 + n + 4  # length, its crc, the record, its crc
        for v in ev.summary.value:
            value = (v.simple_value if v.HasField("simple_value")
                     else float(np.frombuffer(v.tensor.tensor_content,
                                              np.float32)[0]) if
                     v.tensor.tensor_content else v.tensor.float_val[0])
            out.append((v.tag, ev.step, value))
    return out


def _jsonl(path: str) -> list:
    with open(os.path.join(path, "scalars.jsonl")) as f:
        return [(r["tag"], r["step"], np.float32(r["value"]))
                for r in map(json.loads, f)]


def test_event_file_equals_json_lines(tmp_path):
    w = ScalarWriter(str(tmp_path))
    assert w.tensorboard
    rng = np.random.default_rng(0)
    for step in range(1, 6):
        w.add_scalar("loss", rng.random(), step)
        w.add_scalar("test_value", np.float64(step / 7), step)
    w.flush()
    (path,) = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    assert _events(path) == _jsonl(str(tmp_path))
    w.add_scalar("loss", 0.25, 6)
    w.close()
    got = _events(path)
    assert got == _jsonl(str(tmp_path)) and len(got) == 11

