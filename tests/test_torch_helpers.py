"""Shared helpers for the tests that hold the PyTorch port (``repro_torch``)
against the JAX package (``repro``), plus tests of the helpers themselves.

Inputs are made with numpy from a seed and handed to both frameworks.
Arrays coming out of JAX are read-only views; ``torch.from_numpy`` of one
warns (an error under this suite's ``filterwarnings``), so every crossing
copies.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

# The suite runs in several worker processes at once, and the shapes here
# are small: torch's intra-op thread pool on every worker would only
# oversubscribe the cores (its OpenMP workers spin while they wait).
torch.set_num_threads(1)

# f32 kernel level: the two versions sum the same terms in another order
# (blockwise online softmax vs one softmax, other tile sizes)
KERNEL_TOL = dict(atol=2e-5, rtol=1e-5)
# f32 model logits on the reduced configs: two layers of matmuls, norms and
# softmaxes in two frameworks, each with its own reduction order
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def to_torch(x, dtype=None) -> torch.Tensor:
    """A CPU tensor holding a copy of a numpy or JAX array."""
    t = torch.from_numpy(np.array(x, copy=True))
    return t if dtype is None else t.to(dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def params_to_numpy(params):
    """A JAX param pytree with every leaf copied into a writable numpy
    array (the input ``convert.params_from_jax`` takes)."""
    return jax.tree.map(lambda x: np.array(x, copy=True), params)


def load_jax_params(cfg_t, params):
    """A port ``Transformer`` on the CPU carrying the JAX weights."""
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.model import Transformer
    model = Transformer(cfg_t, device="cpu")
    model.load_state_dict(params_from_jax(params_to_numpy(params), cfg_t))
    return model


def jax_loss_and_grads(cfg_j, params, batch, ctx):
    """The reference's LM loss, logits and parameter gradients of one
    packed batch (numpy arrays; with ``plan`` the CAD plan is bound)."""
    from repro.models import model as JM
    from repro.train.loss import lm_loss as j_lm_loss
    jb = {k: jnp.asarray(batch[k]) for k in
          ("tokens", "labels", "segment_ids", "positions")}
    if "plan" in batch:
        ctx = ctx.cad.bind_plan(ctx, jax.tree.map(jnp.asarray,
                                                  batch["plan"]))

    def loss_fn(p):
        logits, _ = JM.forward(p, cfg_j, jb, ctx)
        return j_lm_loss(logits, jb["labels"], jb["segment_ids"])[0], logits
    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    return loss, logits, grads


def torch_loss_and_grads(model, batch, ctx):
    """The port's LM loss, logits and gradients (by parameter name) of the
    same batch, on the CPU."""
    from repro_torch.train.loss import lm_loss
    from repro_torch.train.step import batch_to_device
    b = batch_to_device(batch, "cpu")
    if "plan" in b:
        ctx = ctx.cad.bind_plan(ctx, b["plan"])
    logits, _ = model(b, ctx)
    loss, _ = lm_loss(logits, b["labels"], b["segment_ids"])
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    return loss, logits, dict(zip(names, grads))


def test_to_torch_copies_read_only_jax_arrays():
    x = jnp.arange(6, dtype=jnp.float32).reshape(2, 3)
    t = to_torch(x)
    t += 1                                  # writable, and a copy
    np.testing.assert_array_equal(np.asarray(x) + 1, t.numpy())


def test_params_to_numpy_gives_writable_leaves():
    tree = {"a": jnp.ones(3), "b": (jnp.zeros((2, 2)),)}
    out = params_to_numpy(tree)
    assert all(leaf.flags.writeable for leaf in jax.tree.leaves(out))
