"""Puts the repository root and ``src`` on the path, and gives the tests a
copy of the benchmark with a cell small enough for the CPU."""
import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

# a cell of smollm-360m's kind cut to the CPU: every width small, the
# traffic a tenth of a row; the limits are smollm360m.cad.prolong16k's
TINY_SHAPE = {"n_layers": 2, "d_model": 128, "n_heads": 4, "n_kv_heads": 2,
              "head_dim": 32, "d_ff": 256, "vocab_size": 512}
TINY_OF = "smollm360m.cad.prolong16k"


def tiny_cell(root: Path) -> dict:
    """Write a CPU-sized configuration, traffic and cell named ``tiny``
    under ``root`` (a copy of ``cadbench/``), and add it to the copy's
    ``BENCHMARK.json``; returns the BENCHMARK entry."""
    src = json.loads((root / "workloads" / f"{TINY_OF}.json").read_text())
    conf = json.loads((root / "configs" / f"{src['config']}.json")
                      .read_text())
    conf = dict(conf, name="tiny", overrides=dict(TINY_SHAPE),
                shape=dict(conf["shape"], **TINY_SHAPE))
    traffic = json.loads((root / "traffic" / f"{src['traffic']}.json")
                         .read_text())
    traffic = dict(traffic, name="tiny", max_doc_len=512, seq_len=512)
    cell = dict(copy.deepcopy(src), name="tiny", config="tiny",
                traffic="tiny")
    for kind, obj in (("configs", conf), ("traffic", traffic),
                      ("workloads", cell)):
        (root / kind / "tiny.json").write_text(json.dumps(obj))
    bench_path = root.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    entry = {"name": "tiny", "config": "tiny", "traffic": "tiny", "chips": 1,
             "why": "CPU test cell"}
    bench["workloads"].append(entry)
    bench_path.write_text(json.dumps(bench))
    return entry


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of ``cadbench/`` and ``BENCHMARK.json`` under ``tmp_path``;
    returns the copy's ``cadbench`` directory."""
    dst = tmp_path / "checkout" / "cadbench"
    shutil.copytree(REPO / "cadbench", dst,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dst.parent / "BENCHMARK.json")
    return dst
