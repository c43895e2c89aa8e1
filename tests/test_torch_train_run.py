"""The port's diffusion training loop on the CPU: a short run of reduced
cifar10-cld lowers the loss and hands a net to the sampler (the claim of
`tests/test_train_integration.py`), the sampler reads the trained net as
the JAX package's does, and the training CLI (`repro_torch.launch.train`)
checkpoints, resumes and dispatches `--arch` to LM training.

The CLD runs use `grid_substeps=1`: its R_t grid solve costs ~9 s a CLD
instance at the default 8 substeps.  The CLI runs use cifar10-ddpm
(VPSDE, closed form) for the same reason.
"""
import dataclasses
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sde as jsde
import repro_torch.sde as tsde
from repro.configs import get_diffusion as jget
from repro_torch import convert
from repro_torch import random as prng
from repro_torch.configs import get_diffusion as tget
from repro_torch.core import time_grid
from repro_torch.data.pipeline import MixturePipeline
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.optim import adamw as tadamw


def memoized_cld(cls):
    """A CLD (grid_substeps=1) whose float64 closed forms are cached per
    argument: the same values bit for bit, the Stage-I quadratures of
    each sampler call only stop recomputing them."""
    sde = cls(grid_substeps=1)
    for name in ("F_np", "G2_np", "Psi_np", "Sigma_np", "R_np",
                 "_sigma_exact"):
        setattr(sde, name, functools.lru_cache(maxsize=None)(
            getattr(sde, name)))
    return sde


@pytest.fixture(scope="module")
def trained_cld():
    """Reduced cifar10-cld after 60 steps on one tight mixture mode:
    (spec, net, losses)."""
    spec = dataclasses.replace(tget("cifar10-cld", reduced=True),
                               sde=memoized_cld(tsde.CLD))
    net = spec.init(seed=0, device="cpu").requires_grad_()
    cfg = tadamw.AdamWCfg(lr=2e-3, warmup_steps=5, total_steps=80,
                          weight_decay=0.0)
    st = tadamw.adamw_init(net.parameters(), cfg)
    means = np.zeros((1,) + tuple(spec.data_shape))
    means[0, :4, :4] = 0.8
    it = MixturePipeline(means=means, stds=np.array([0.05]),
                         weights=np.array([1.0]),
                         global_batch=32).iterator(0, device="cpu")
    step_fn = tsteps.make_diffusion_train_step(spec, cfg)
    key = prng.PRNGKey(1)
    losses = [float(step_fn(net, st, {"x0": next(it)["x0"]},
                            prng.fold_in(key, i))["loss"])
              for i in range(60)]
    return spec, net.requires_grad_(False), losses


def test_loss_falls_on_reduced_cld(trained_cld):
    """The claim of tests/test_train_integration.py: a short run of
    reduced cifar10-cld on one tight mixture mode lowers the loss."""
    spec, net, losses = trained_cld
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.05, losses[::6]
    x = spec.sample(net, prng.PRNGKey(2), 8, 10, q=1, device="cpu")
    assert x.shape == (8,) + tuple(spec.data_shape)
    assert torch.isfinite(x).all()


class _Negated(torch.nn.Module):
    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, u, t):
        return -self.net(u, t)


def test_trained_net_hands_off_to_the_sampler(trained_cld):
    """The sampler reads the trained net as the JAX package's sampler
    does: 64 samples (nfe 10, q 2) from the same trained weights and key
    agree within 1e-5 of their scale.  CLD's flow run backward amplifies
    by Psi(t_min, T) (entries ~5e4), so with eps = 0 (the zero-init
    net's) the samples are Psi(t_min, T) u_T, of std S0 = sqrt((Psi
    Sigma_T Psi^T)_xx) ~ 3.1e4 in closed form, and a net trained a few
    steps, whose eps is still far from the exact one, stays near that
    scale (`test_exact_eps_trains_and_samples` has the exact eps)."""
    spec, net, _ = trained_cld
    sde, jspec = spec.sde, jget("cifar10-cld", reduced=True)
    jspec = dataclasses.replace(jspec, sde=memoized_cld(jsde.CLD))
    got = spec.sample(net, prng.PRNGKey(7), 64, 10, q=2, device="cpu")
    tree = convert.to_jax_params(net.state_dict())
    with jax.threefry_partitionable(False):
        want = np.asarray(jspec.sample(jax.tree.map(jnp.asarray, tree),
                                       jax.random.PRNGKey(7), 64, 10, q=2))
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale
    zero = spec.sample(spec.init(seed=0, device="cpu"), prng.PRNGKey(7), 64,
                       10, q=2, device="cpu")
    s0 = zero_eps_std(sde, 10)
    assert abs(float(zero.std()) / s0 - 1) <= 0.02, (float(zero.std()), s0)


def zero_eps_std(sde, nfe: int) -> float:
    """The std of the data part of Psi(t_min, T) u_T, u_T ~ N(0, Sigma_T):
    what the sampler returns for eps = 0, in closed form (float64)."""
    ts = time_grid(sde, nfe, "quadratic")
    psi = np.asarray(sde.Psi_np(ts[0], ts[-1]), np.float64)
    cov = psi @ np.asarray(sde.Sigma_np(ts[-1]), np.float64) @ psi.T
    return float(np.sqrt(cov[0, 0]))


def test_exact_eps_trains_and_samples():
    """The loss and the sampler read eps the same way: on reduced
    cifar10-cld's own training data (the driver's four-mode mixture), the
    exact eps (`ExactScore.eps_model`, -K_t^T score) scores the loss's
    floor (under 0.1 over three keys), below the zero eps's 1 and far
    below its negation's 1 + 3 E|eps*|^2; through `DiffusionSpec.sample`
    (nfe 10, q 2) it puts every sample within the mode's std (0.05, rms a
    coordinate) of a mode, all four modes taken."""
    spec = dataclasses.replace(tget("cifar10-cld", reduced=True),
                               sde=memoized_cld(tsde.CLD))
    pipe = ttrain.diffusion_pipeline(spec, 32, 0)
    exact = tsde.ExactScore(spec.sde, tsde.GaussianMixture(
        pipe.means, pipe.stds, pipe.weights)).eps_model()
    x0 = torch.from_numpy(pipe.batch_at(0))
    loss = {name: np.mean([float(spec.loss(fn, x0, prng.fold_in(
        prng.PRNGKey(0), i))) for i in range(3)]) for name, fn in (
        ("exact", exact), ("negated", lambda u, t: -exact(u, t)),
        ("zero", lambda u, t: torch.zeros_like(u)))}
    assert loss["exact"] < 0.1 and abs(loss["zero"] - 1) < 0.05 \
        and loss["negated"] > 3, loss
    x = spec.sample(exact, prng.PRNGKey(7), 64, 10, q=2,
                    device="cpu").numpy()
    means = np.asarray(pipe.means, np.float32).reshape(4, -1)
    rms = np.sqrt(((x.reshape(64, 1, -1) - means[None]) ** 2).mean(-1))
    assert rms.min(1).max() <= 0.05, rms.min(1)
    assert set(rms.argmin(1).tolist()) == {0, 1, 2, 3}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_train_driver_runs_and_resumes():
    with tempfile.TemporaryDirectory() as d:
        common = ["--diffusion", "cifar10-ddpm", "--reduced", "--batch", "4",
                  "--ckpt-dir", d, "--log-every", "0", "--device", "cpu"]
        assert ttrain.main(common + ["--steps", "4", "--ckpt-every", "2"]) == 0
        assert sorted(n for n in os.listdir(d) if n.startswith("step_")) \
            == ["step_2", "step_4"]
        assert ttrain.main(common + ["--steps", "6", "--resume"]) == 0
        assert open(os.path.join(d, "latest")).read() == "step_6"
    assert ttrain.main(["--arch", "gemma3-1b", "--reduced", "--steps", "1",
                        "--batch", "2", "--seq-len", "8", "--log-every", "0",
                        "--device", "cpu"]) == 0


def test_resume_matches_uninterrupted_run():
    args = lambda **kw: type("A", (), dict(
        diffusion="cifar10-ddpm", reduced=True, batch=4, lr=3e-4, seed=0,
        log_every=0, device="cpu", resume=True, ckpt_every=0, **kw))
    straight = ttrain.train_diffusion(args(steps=4, ckpt_dir=None))
    with tempfile.TemporaryDirectory() as d:
        ttrain.train_diffusion(args(steps=2, ckpt_dir=d))
        resumed = ttrain.train_diffusion(args(steps=4, ckpt_dir=d))
    assert resumed["last_loss"] == straight["last_loss"]
    for a, b in zip(straight["net"].parameters(),
                    resumed["net"].parameters()):
        assert torch.equal(a, b)


def test_preempted_run_resumes_through_on_step():
    """`on_step` sees the state at every step (the restored one first); a
    true return ends the run there with its checkpoint, and --resume with
    the same --steps (so the same cosine schedule) ends bitwise where the
    uninterrupted run does."""
    args = lambda **kw: type("A", (), dict(
        diffusion="cifar10-ddpm", reduced=True, batch=4, lr=3e-4, seed=0,
        log_every=0, device="cpu", steps=8, **kw))
    seen = []
    straight = ttrain.train_diffusion(
        args(ckpt_dir=None, ckpt_every=0, resume=False),
        on_step=lambda s, net, st, m: seen.append((s, m is None)))
    assert seen == [(0, True)] + [(s, False) for s in range(1, 9)]
    with tempfile.TemporaryDirectory() as d:
        cut = ttrain.train_diffusion(
            args(ckpt_dir=d, ckpt_every=3, resume=False),
            on_step=lambda s, net, st, m: s >= 6)
        assert cut["step"] == 6 and int(cut["opt_state"].step) == 6
        assert sorted(n for n in os.listdir(d) if n.startswith("step_")) \
            == ["step_3", "step_6"]
        firsts = []
        resumed = ttrain.train_diffusion(
            args(ckpt_dir=d, ckpt_every=0, resume=True),
            on_step=lambda s, net, st, m: firsts.append(
                (s, [p.detach().clone() for p in net.parameters()]))
            if m is None else None)
        assert open(os.path.join(d, "latest")).read() == "step_8"
    assert [s for s, _ in firsts] == [6]
    for a, b in zip(firsts[0][1], cut["net"].parameters()):
        assert torch.equal(a, b.detach())
    assert resumed["step"] == 8 and resumed["last_loss"] == \
        straight["last_loss"]
    for a, b in zip(straight["net"].parameters(),
                    resumed["net"].parameters()):
        assert torch.equal(a, b)
