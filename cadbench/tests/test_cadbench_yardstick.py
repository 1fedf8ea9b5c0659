"""The yardstick's frozen copies: the traffic equals the port's, the work
counts equal brute-force counts, the configurations build their stated
shapes."""
import json

import numpy as np
import pytest
import torch

from cadbench import harness
from cadbench.frozen import data as fdata
from cadbench.frozen import work
from cadbench.reference.weights import n_params, param_specs

CELLS = sorted(p.stem for p in (harness.ROOT / "workloads").glob("*.json"))
CONFIGS = sorted(p.stem for p in (harness.ROOT / "configs").glob("*.json"))


@pytest.mark.parametrize("name", CELLS)
def test_frozen_traffic_is_the_ports(name):
    """The copy's batches equal ``raw_batches`` at the cell's
    PipelineConfig, rows cut to 2048 tokens."""
    from repro_torch.data.pipeline import PipelineConfig, raw_batches
    cell = harness.load_cell(name)
    t = harness.traffic_config(cell)
    t.seq_len, t.max_doc_len = 2048, min(t.max_doc_len, 2048)
    ours = fdata.raw_batches(t)
    port = raw_batches(PipelineConfig(
        distribution=t.distribution, max_doc_len=t.max_doc_len,
        seq_len=t.seq_len, global_batch=t.global_batch,
        n_ranks=cell["cad"]["servers"], vocab_size=t.vocab_size,
        seed=t.seed, strategy=t.strategy))
    for _ in range(3):
        a, b = next(ours), next(port)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def _mask(seg, pos):
    same = (seg[:, None] == seg[None, :]) & (seg[:, None] > 0)
    return same & (pos[:, None] >= pos[None, :])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_work_counts_equal_brute_force(seed):
    """Causal pairs, model FLOPs and the attention kernels' FLOPs and bytes
    against a count over the document mask and the tensors' sizes."""
    t = fdata.TrafficConfig("prolong", 384, 1024, 2, 500, seed)
    b = next(fdata.raw_batches(t))
    pairs = sum(int(_mask(s, p).sum()) for s, p in
                zip(b["segment_ids"], b["positions"]))
    segs = fdata.segment_lengths(b["segment_ids"])
    assert work.causal_pairs(segs) == pairs
    shape = {"n_layers": 3, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
             "head_dim": 16, "d_ff": 96, "vocab_size": 500,
             "tie_embeddings": True, "gated_mlp": True}
    tokens = int((b["segment_ids"] > 0).sum())
    # every product of the step: the matrices' multiply-adds a token
    macs = sum(torch.Size(s).numel() for n, s, init in param_specs(shape)
               if init != "ones" and n != "embed") + 500 * 64
    attn = 3 * 4 * 16 * 2 * pairs          # layers x heads x dh x QK and PV
    assert work.model_flops(shape, tokens, segs) == \
        pytest.approx(3 * (2 * macs * tokens + 2 * attn))
    f, nbytes = work.ca_fwd_work(shape, tokens, segs)
    assert f == 2 * attn / 3
    q = out = tokens * 4 * 16 * 2
    k = v = tokens * 2 * 16 * 2
    lse = tokens * 4 * 4
    assert nbytes == q + k + v + out + lse
    fb, bb = work.ca_bwd_work(shape, tokens, segs)
    assert fb == 2.5 * f
    assert bb == (q + k + v + out + out + lse) + (q + k + v)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_builds_its_stated_shape(name):
    """The port builds each configuration file's shape; its parameters are
    the file's count (361.8 M and 2.189 B) and the weights' names."""
    from repro_torch.models.model import Transformer
    conf = json.loads((harness.ROOT / "configs" / f"{name}.json")
                      .read_text())
    cfg = harness.model_config({"config_file": conf})
    model = Transformer(cfg, device="meta")
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = {n: s for n, s, _ in param_specs(conf["shape"])}
    assert got == want
    count = sum(p.numel() for p in model.parameters())
    assert count == conf["params"] == n_params(conf["shape"]) \
        == cfg.n_params() + cfg.d_model * (2 * cfg.n_layers + 1)
    assert round(count / 1e6, 1) in (361.8, 2189.5)
    for key, r in conf["reduced"].items():
        assert conf["published"][key] == r["published"]


def test_reference_attention_is_a_masked_softmax():
    """The reference's blockwise attention and its recomputing backward
    against a dense softmax over the document-causal mask (GQA 2, three
    documents, padding between them), blocks smaller than a document."""
    from cadbench.reference import model as ref
    torch.manual_seed(0)
    S, hq, hkv, dh = 700, 4, 2, 16
    docs = [(0, 300), (384, 250), (640, 60)]
    q = torch.randn(S, hq, dh, dtype=torch.float64, requires_grad=True)
    k = torch.randn(S, hkv, dh, dtype=torch.float64, requires_grad=True)
    v = torch.randn(S, hkv, dh, dtype=torch.float64, requires_grad=True)
    g = torch.randn(S, hq, dh, dtype=torch.float64)
    saved = ref.ATTN_BLOCK_ELEMS
    ref.ATTN_BLOCK_ELEMS = hq * 300 * 40
    try:
        got = ref.DocAttention.apply(q, k, v, docs)
        grads = torch.autograd.grad(got, (q, k, v), g)
    finally:
        ref.ATTN_BLOCK_ELEMS = saved
    seg = torch.zeros(S, dtype=torch.long)
    pos = torch.zeros(S, dtype=torch.long)
    for i, (s0, L) in enumerate(docs):
        seg[s0:s0 + L] = i + 1
        pos[s0:s0 + L] = torch.arange(L)
    mask = (seg[:, None] == seg[None, :]) & (seg[:, None] > 0) \
        & (pos[:, None] >= pos[None, :])
    kr, vr = (t.repeat_interleave(hq // hkv, 1) for t in (k, v))
    s = torch.einsum("qhd,khd->hqk", q, kr) * dh ** -0.5
    p = torch.nan_to_num(torch.softmax(s.masked_fill(~mask, -torch.inf),
                                       -1))
    want = torch.einsum("hqk,khd->qhd", p, vr)
    for a, b in zip((got, *grads),
                    (want, *torch.autograd.grad(want, (q, k, v), g))):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
    assert ref.documents(seg.numpy(), pos.numpy()) == docs
