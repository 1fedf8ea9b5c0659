"""What decides ``correct``, driven on the CPU at a small cell with the
limits of smollm360m.cad.prolong16k: a sound run passes; the control (the
reference in fp8 in the program's place) and each fault a training cell
can have, planted under the timed path, come out not correct.  The
harness's look for a card is skipped (``run.execute``)."""
import importlib.util

import pytest
import torch

from conftest import tiny_cell

SEED = 2 ** 31 + 17


@pytest.fixture
def tiny_run(bench_copy):
    torch.set_num_threads(4)
    entry = tiny_cell(bench_copy)
    spec = importlib.util.spec_from_file_location("cadbench_copy_run",
                                                  bench_copy / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    import json
    bench = json.loads((bench_copy.parent / "BENCHMARK.json").read_text())

    def go():
        return run.execute(bench, entry, SEED, 8.0, 0, device="cpu",
                           root=bench_copy)
    return go


def test_sound_run_is_correct(tiny_run):
    line = tiny_run()
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 4 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert line["metrics"]["tokens_per_s"]["value"] > 0


def test_state_left_unchanged_is_not_correct(tiny_run, monkeypatch):
    from repro_torch.optim import adamw

    def unchanged(self, grads, state, params, decay, norm_groups=None):
        gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        return adamw.AdamWState(step=state.step + 1, mu=state.mu,
                                nu=state.nu), gnorm
    monkeypatch.setattr(adamw.AdamW, "update", unchanged)
    line = tiny_run()
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] > \
        line["checks"]["change_gap"]["limit"]


def test_half_batch_left_out_is_not_correct(tiny_run, monkeypatch):
    from repro_torch.train import step
    whole = step.lm_loss

    def half(logits, labels, segment_ids):
        r = logits.shape[0] // 2
        return whole(logits[:r], labels[:r], segment_ids[:r])
    monkeypatch.setattr(step, "lm_loss", half)
    line = tiny_run()
    assert not line["correct"], line["checks"]


def test_fp8_control_is_not_correct():
    from cadbench import compare, harness
    from cadbench.reference.model import train_steps
    from conftest import TINY_OF, TINY_SHAPE
    cell = harness.load_cell(TINY_OF)
    shape = dict(cell["config_file"]["shape"], **TINY_SHAPE)
    cell["traffic_file"].update(max_doc_len=512, seq_len=512)
    cell["config_file"]["shape"] = shape
    b = harness.batches(cell, cell["compare_steps"])
    first = {}
    ref = train_steps(shape, SEED, b, cell["train"], "cpu",
                      on_first_grad=lambda g: first.update(
                          {n: t.clone() for n, t in g.items()}))
    diff, diffs = compare.grad_diff_norms(first)
    fp8 = train_steps(shape, SEED, b, cell["train"], "cpu", precision="fp8",
                      on_first_grad=diff)
    ok, checks = compare.judge(
        compare.gaps(dict(fp8, grad_diff_norms=diffs), ref), cell["limits"])
    assert not ok, checks
