"""mfu: the whole step's model FLOPs over the traced window's host-clock
time, as a share of the bf16 peak (%).  Model FLOPs are
6·N·tokens + 12·layers·heads·head_dim·sum L(L+1)/2 a step
(``frozen.work.model_flops``), remat recompute not counted."""
from cadbench.frozen.work import PEAK_BF16_FLOPS, model_flops


def read(rec):
    if not rec.steps or rec.window_s <= 0:
        return None
    flops = sum(model_flops(rec.shape, s["tokens"], s["segments"])
                for s in rec.steps)
    return 100.0 * flops / (rec.window_s * PEAK_BF16_FLOPS)
