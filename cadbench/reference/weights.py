"""The weights of a cell, drawn from ``--seed`` on the device in a few
large calls, in the type they are trained in.  The benchmark hands them
to the program, and the reference draws them again from the same seed.

Every matrix is normal(0, 1) times fan_in**-0.5, drawn as one flat
buffer in the parameters' dtype by one ``normal_`` call and scaled in
place; every norm scale is 1.  The names are the decoder's parameter
names (``embed``, ``unembed`` unless tied, ``final_norm.scale``,
``layers.<i>.{norm1,norm2}.scale``, ``layers.<i>.attn.{wq,wk,wv,wo}``,
``layers.<i>.ffn.{w_gate,w_up,w_down}``), matrices stored [in, out].
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def param_specs(shape: Dict) -> List[Tuple[str, tuple, object]]:
    """(name, shape, fan_in or "ones") of every parameter, in draw order."""
    d, dh, f = shape["d_model"], shape["head_dim"], shape["d_ff"]
    hq, hkv, v = shape["n_heads"], shape["n_kv_heads"], shape["vocab_size"]
    specs = [("embed", (v, d), d)]
    if not shape["tie_embeddings"]:
        specs.append(("unembed", (v, d), d))
    specs.append(("final_norm.scale", (d,), "ones"))
    for i in range(shape["n_layers"]):
        p = f"layers.{i}."
        specs += [(p + "norm1.scale", (d,), "ones"),
                  (p + "attn.wq", (d, hq * dh), d),
                  (p + "attn.wk", (d, hkv * dh), d),
                  (p + "attn.wv", (d, hkv * dh), d),
                  (p + "attn.wo", (hq * dh, d), hq * dh),
                  (p + "norm2.scale", (d,), "ones")]
        if shape.get("gated_mlp", True):
            specs.append((p + "ffn.w_gate", (d, f), d))
        specs += [(p + "ffn.w_up", (d, f), d),
                  (p + "ffn.w_down", (f, d), f)]
    return specs


def n_params(shape: Dict) -> int:
    out = 0
    for _, s, _ in param_specs(shape):
        n = 1
        for x in s:
            n *= x
        out += n
    return out


def make_weights(shape: Dict, seed: int, device, dtype=torch.bfloat16) \
        -> Dict[str, torch.Tensor]:
    """Every parameter, drawn from ``seed`` with a generator on
    ``device``: views into one flat buffer for the matrices."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    specs = param_specs(shape)
    sizes = [(torch.Size(s).numel() if init != "ones" else 0)
             for _, s, init in specs]
    flat = torch.empty(sum(sizes), dtype=dtype, device=device)
    flat.normal_(generator=gen)
    out, off = {}, 0
    for (name, s, init), n in zip(specs, sizes):
        if init == "ones":
            out[name] = torch.ones(s, dtype=dtype, device=device)
        else:
            out[name] = flat[off:off + n].view(s).mul_(init ** -0.5)
            off += n
    return out
