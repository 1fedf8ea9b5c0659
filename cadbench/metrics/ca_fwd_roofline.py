"""ca_fwd_roofline: the least time the attention forwards of the traced
steps need, over the device time of the CA-server forward kernels (%).
Each forward pass the window ran (every layer's, the remat recompute
included, counted at the layers' attention inputs) needs the larger of
its FLOPs at the bf16 peak and its bytes at the HBM rate
(``frozen.work.ca_fwd_work``), reckoned from the batch and the model's
shapes."""
from cadbench.frozen.work import ca_fwd_work, least_seconds


def read(rec):
    us = sum(k["end"] - k["start"] for k in rec.kernels
             if k["family"] == "CA-server kernels"
             and k["short"].startswith("ca_fwd"))
    if not us:
        return None
    need = sum(s["fwd_passes"] * least_seconds(
        *ca_fwd_work(rec.shape, s["tokens"], s["segments"]))
        for s in rec.steps)
    return 100.0 * need / (us / 1e6)
