"""ca_bwd_roofline: the least time the attention backwards of the traced
steps need (one a layer a step), over the device time of the CA-server
dq and dk/dv kernels (%) (``frozen.work.ca_bwd_work``)."""
from cadbench.frozen.work import ca_bwd_work, least_seconds


def read(rec):
    us = sum(k["end"] - k["start"] for k in rec.kernels
             if k["family"] == "CA-server kernels"
             and not k["short"].startswith("ca_fwd"))
    if not us:
        return None
    need = sum(rec.shape["n_layers"] * least_seconds(
        *ca_bwd_work(rec.shape, s["tokens"], s["segments"]))
        for s in rec.steps)
    return 100.0 * need / (us / 1e6)
