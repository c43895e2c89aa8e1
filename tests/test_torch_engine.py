"""The port's serving engine against the JAX package's, end to end.

A reduced `cifar10-cld` DiffusionEngine serves the same mixed request list
in both packages — deterministic with and without the corrector,
stochastic gddim and gmm, and accel — with the same random non-zero DiT weights
(carried by `repro_torch.convert`), at batch 4 so that a slot retires and
is refilled.  The JAX side runs under `jax.threefry_partitionable(False)`,
the counter layout the port implements.

Tier: a stated bound on the served samples, max |port - jax| <= 1e-5 of
the sample's largest magnitude (random weights are no trained score: the
samples reach 1e4-1e5, so the bound is relative to their scale).  The bank is bitwise and the noise bits are exact
(test_torch_coeffs.py, test_torch_random.py); what remains are the f32
rounding differences of the DiT (test_torch_dit.py), the CLD prior's 2x2
apply and the kf=2 factor applies (test_torch_round_fused.py), carried
through at most 5 sampler steps.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import sde as jsde
from repro.configs import get_diffusion as jget
from repro.serve import DiffusionEngine as JEngine
from repro.serve import ServeRequest as JRequest
from repro_torch import convert
from repro_torch import sde as tsde
from repro_torch.configs import get_diffusion as tget
from repro_torch.serve import DiffusionEngine as TEngine
from repro_torch.serve import ServeRequest, Scheduler, SlotTable

# two Stage-I keys, (nfe 4, q 1, lam 0) and (nfe 5, q 1, lam 0.5); q = 2 is
# covered by test_torch_coeffs.py and test_torch_round_fused.py
MIX = [dict(nfe=4), dict(nfe=4, corrector=True), dict(nfe=5, lam=0.5),
       dict(nfe=5, lam=0.5, algorithm="gmm"), dict(nfe=4, algorithm="accel")]
BOUND = 1e-5


def _random_tree(shapes, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda leaf: (rng.standard_normal(leaf.shape)
                      / np.sqrt(leaf.shape[-2] if leaf.ndim >= 2 else 8)
                      ).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def served():
    jsde_cld = jsde.CLD(grid_substeps=1)
    for name in ("Psi_np", "Sigma_np", "R_np"):
        # pure float64 closed forms: caching them per argument changes no
        # value, it only spares the reference's Stage I repeated expm calls
        setattr(jsde_cld, name, functools.lru_cache(maxsize=None)(
            getattr(jsde_cld, name)))
    jspec = dataclasses.replace(jget("cifar10-cld", reduced=True),
                                sde=jsde_cld)
    tspec = dataclasses.replace(tget("cifar10-cld", reduced=True),
                                sde=tsde.CLD(grid_substeps=1))
    tree = _random_tree(jspec.param_shapes(), seed=5)
    net = tspec.init(seed=0, device="cpu")
    net.load_state_dict(convert.from_jax_params(tree))

    wire = [ServeRequest(rid=i, seed=10 + i, **kw).to_wire()
            for i, kw in enumerate(MIX)]
    jeng = JEngine(jspec, jax.tree.map(jnp.asarray, tree), batch_size=4,
                   nfe=4)
    with jax.threefry_partitionable(False):
        want = jeng.serve([JRequest.from_wire(w) for w in wire])
    teng = TEngine(tspec, net, batch_size=4, nfe=4, device="cpu")
    got = teng.serve([ServeRequest.from_wire(w) for w in wire])
    return jeng, want, teng, got


def test_engine_serves_the_jax_samples(served):
    jeng, want, teng, got = served
    assert sorted(got) == sorted(want) == list(range(len(MIX)))
    for rid in want:
        a, b = np.asarray(want[rid]), got[rid]
        assert b.shape == a.shape == (8, 8, 3) and np.isfinite(b).all()
        assert np.abs(a).max() > 0.1
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=BOUND * np.abs(a).max(),
                                   err_msg=f"request {rid} {MIX[rid]}")


def test_engine_bookkeeping_matches_jax(served):
    jeng, _, teng, _ = served
    assert teng.n_rounds == jeng.n_rounds
    assert teng.n_steps == jeng.n_steps
    assert teng.n_polls == jeng.n_polls
    assert teng.wave_log == jeng.wave_log
    assert teng.n_samples_out == jeng.n_samples_out == len(MIX)
    assert [dataclasses.asdict(c) for c in teng.cache.configs] == \
        [dataclasses.asdict(c) for c in jeng.cache.configs]


@pytest.mark.parametrize("kw", [dict(nfe=6, q=2), dict(lam=0.5, grid="uniform"),
                                dict(algorithm="gmm", lam=0.3, priority=2)])
def test_wire_form_is_the_jax_packages(kw):
    req = ServeRequest(rid=7, seed=3, **kw)
    assert req.to_wire() == JRequest(rid=7, seed=3, **kw).to_wire()
    assert ServeRequest.from_wire(req.to_wire()) == req


def test_scheduler_groups_head_of_line():
    s = Scheduler(group_key=lambda r: r % 2)
    s.submit_all([1, 3, 2, 5, 4])
    assert s.take_group(4) == [1, 3]
    assert s.take_group(1) == [2]
    assert s.take_group(4) == [5]
    assert s.n_pending == 1


def test_slot_table_assign_release():
    t = SlotTable(3)
    t.assign(1, "r", k=0)
    assert t.free_ids() == [0, 2] and t.active_ids() == [1]
    with pytest.raises(RuntimeError):
        t.assign(1, "s")
    t.release(1)
    assert t.free_ids() == [0, 1, 2]


def test_engine_rejects_unserved_requests(served):
    _, _, teng, _ = served
    for kw in (dict(precision="fp4"), dict(family="vpsde"),
               dict(q=2, lam=0.5)):
        with pytest.raises(ValueError):
            teng.serve([ServeRequest(rid=0, **kw)])
