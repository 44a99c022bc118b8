"""bf16 parity for every model family: each arch of ``ASSIGNED_ARCHS`` at
its ``reduced()`` size with the config's own bf16 parameters and
activations, the port's logits against the JAX package's on the CPU, on
the reference's initialised parameters (carried across exactly:
``convert.params_from_numpy`` casts the float32 copy of each bf16 leaf back
to bf16) and one ``make_inputs`` batch.

Tolerance: bf16 keeps 8 significand bits, so one rounding moves a value by
up to 2**-8 of its size. Both packages round the residual stream and each
product's output to bf16 at the same places, but sum the products in other
orders, so each of the up-to-4 layers can differ by a rounding or two:
``max|got - want| <= 0.03 * max|want|`` (about 4-8 bf16 steps of the
largest logit; 0.87-2.40% measured on these inputs). Where the reference's
top two logits differ by more than twice that bound, the argmax agrees.
The VLM's gate is set to 0.5 (a zero gate would hide the cross attention).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models.registry import build_model as j_build_model
from repro_torch.configs.base import ASSIGNED_ARCHS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models.registry import build_model, make_inputs

REL_TOL = 0.03


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tensors are small: one intra-op thread runs them faster than
    many, and the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(v: torch.Tensor):
    if v.dtype == torch.bfloat16:
        return jnp.asarray(v.float().numpy(), jnp.bfloat16)
    return jnp.asarray(v.numpy())


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_bf16_logits_match_reference(arch):
    cfg, j_cfg = get_config(arch).reduced(), j_get_config(arch).reduced()
    assert cfg.dtype == cfg.param_dtype == "bfloat16"
    j_model = j_build_model(j_cfg)
    j_params = jax.jit(j_model.init)(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                  j_params)
    if "cross" in tree:
        tree["cross"]["gate"][:] = 0.5
    j_params = jax.tree_util.tree_map(lambda x, like: jnp.asarray(
        x, like.dtype), tree, j_params)
    batch = make_inputs(cfg, 2, 32, np.random.default_rng(0), device="cpu")
    want = np.asarray(j_model.logits(
        j_params, {k: _jax(v) for k, v in batch.items()}), np.float32)
    with torch.no_grad():
        got = build_model(cfg).logits(
            params_from_numpy(tree, cfg, device="cpu"), batch)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert got.shape == want.shape
    bound = REL_TOL * np.abs(want).max()
    assert np.abs(got - want).max() <= bound
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * bound
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])
