"""Parity of the port's DiT score net with the JAX package's `dit_apply`.

Both nets get the same weights — a numpy tree drawn from a seed, with a
random non-zero value in EVERY leaf (the JAX init zeroes `patch_out` and
the biases, which would hide most of the net) — carried into the port by
`repro_torch.convert.from_jax_params`.

Tier: tight tolerance, f32 at the reduced CLD config: rtol 1e-4, atol 1e-5
on eps (values of order 1).  Both sides compute in f32; they differ in
matmul and reduction order and in the transcendental implementations
(exp/cos/sin/tanh/rsqrt), each a few ulp, through two layers.  bf16 at full
width is held against the plain version on the card by chip_smoke.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_diffusion as jget
from repro.models import score_net as jsn
from repro_torch import convert
from repro_torch.configs import get_diffusion as tget
from repro_torch.models import score_net as tsn


def random_tree(shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(leaf):
        fan_in = leaf.shape[-2] if leaf.ndim >= 2 else 8
        return (rng.standard_normal(leaf.shape)
                / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(draw, shapes)


@pytest.fixture(scope="module")
def nets():
    jspec, tspec = jget("cifar10-cld", reduced=True), tget("cifar10-cld",
                                                           reduced=True)
    tree = random_tree(jspec.param_shapes(), seed=11)
    net = tspec.init(seed=0, device="cpu")
    net.load_state_dict(convert.from_jax_params(tree), strict=True)
    return jspec, tree, tspec, net


def test_every_leaf_is_carried_and_nonzero(nets):
    _, tree, _, net = nets
    layer_leaves = jax.tree.leaves(tree["layers"])
    n_leaves = len(jax.tree.leaves(tree)) - len(layer_leaves) \
        + sum(x.shape[0] for x in layer_leaves)
    sd = net.state_dict()
    assert len(sd) == n_leaves
    for name, t in sd.items():
        assert torch.count_nonzero(t) == t.numel(), name


@pytest.mark.parametrize("seed", [0, 1])
def test_dit_eps_matches_jax(nets, seed):
    jspec, tree, tspec, net = nets
    rng = np.random.default_rng(100 + seed)
    u = rng.standard_normal((3,) + jspec.sde.state_shape(
        jspec.data_shape)).astype(np.float32)
    t = rng.uniform(1e-3, 1.0, 3).astype(np.float32)
    apply = jax.jit(jsn.dit_apply, static_argnums=1)
    want = np.asarray(apply(jax.tree.map(jnp.asarray, tree), jspec.score_cfg,
                            jnp.asarray(u), jnp.asarray(t)))
    got = tspec.eps_model(net, torch.from_numpy(u), torch.from_numpy(t))
    assert got.shape == u.shape and got.dtype == torch.float32
    assert np.abs(want).max() > 0.1          # a real score, not ~0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_timestep_embedding_matches_jax():
    t = np.linspace(1e-3, 1.0, 7).astype(np.float32)
    want = np.asarray(jsn.timestep_embedding(jnp.asarray(t), 256))
    got = tsn.timestep_embedding(torch.from_numpy(t), 256).numpy()
    # angles reach 1000 rad: the two f32 cos/sin differ in range reduction
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_dit_keeps_the_bf16_compute_dtype():
    """Full-width config: bf16 weights and activations, f32 eps out (a
    small stand-in with the full config's dtype, run on the CPU)."""
    cfg = dataclasses.replace(tget("cifar10-cld").score_cfg, img_size=8,
                              patch=4, d_model=64, n_layers=1, n_heads=2)
    net = tsn.DiT(cfg, torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    out = net(torch.randn(2, 2, 8, 8, 3), torch.rand(2))
    assert out.dtype == torch.float32 and out.shape == (2, 2, 8, 8, 3)


def test_layer_norm_and_gelu_mlp_match_jax():
    """The DiT's building blocks on their own: layer norm in f32 and in
    bf16 (computed in f32, cast back), and the tanh-GELU MLP."""
    from repro.models import common as jc
    from repro_torch.models import common as tc
    rng = np.random.default_rng(4)
    x = (3 * rng.standard_normal((2, 16, 64)) + 1).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-5),
                          (jnp.bfloat16, torch.bfloat16, 8e-3)):
        want = jc.layer_norm(jnp.asarray(x, jdt), jnp.asarray(g, jdt),
                             jnp.asarray(b, jdt))
        got = tc.layer_norm(torch.from_numpy(x).to(tdt),
                            torch.from_numpy(g).to(tdt),
                            torch.from_numpy(b).to(tdt))
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)
    p = {"w_up": rng.standard_normal((64, 256)).astype(np.float32) / 8,
         "w_down": rng.standard_normal((256, 64)).astype(np.float32) / 16}
    want = jc.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), act="gelu")
    got = tc.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), act="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
