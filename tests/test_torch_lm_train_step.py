"""One train step of the port against the reference's, for all ten
architectures (``repro_torch.train.build_train_step``), on the
reference's weights carried across and one numpy batch fed to both
(the helpers of ``tests/test_torch_lm_train.py``).

* f32: the loss within rel 1e-5, grad_norm within rel 1e-4, lr within
  rel 1e-6, the moments within ``1e-4 max|leaf|``, the new params within
  ``1e-3 lr + 1e-6 |p|`` where the reference's first moment (its clipped
  gradient times 0.1) is above ``1e-3`` of its leaf's largest and within
  ``2 lr + 1e-6 |p|`` elsewhere (Adam's first step is ``lr sign(g)``: a
  near-zero gradient may flip its sign); every leaf moved;
* bf16: the loss within rel 2e-2, grad_norm within rel 5e-2;
* a 5-step run of reduced olmo: the loss trajectory within rel 1e-3.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.optim import adamw_init as r_adamw_init
from repro.train.steps import build_train_step as r_build_train_step
from repro_torch.optim import adamw_init
from repro_torch.tree import leaves as tree_leaves
from repro_torch.train import build_train_step
from test_torch_lm_train import (_batch, _cfg, _flat, _jx, _np,
                                 _port_params, _rel, _weights)

STEP = dict(warmup_steps=2, total_steps=10)


@functools.lru_cache(maxsize=None)
def _ref_step(arch, dtype):
    cfg = _cfg(arch, dtype)
    params = _jx(_weights(arch, dtype))
    fn = jax.jit(r_build_train_step(cfg, **STEP))
    p, o, m = fn(params, r_adamw_init(params), _jx(_batch(cfg)), 1)
    return (_flat(jax.tree.map(np.asarray, p)),
            {k: _flat(jax.tree.map(np.asarray, o[k])) for k in ("m", "v")},
            {k: float(v) for k, v in m.items()})



@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_reference(arch):
    cfg = _cfg(arch)
    r_params, r_moments, r_metrics = _ref_step(arch, "float32")
    params = _port_params(arch)
    start = {k: _np(t) for k, t in _flat(params).items()}
    pp, po, pm = build_train_step(cfg, **STEP)(params, adamw_init(params),
                                               _batch(cfg), 1)
    assert sorted(pm) == ["grad_norm", "loss", "lr"]
    assert all(t.shape == () and t.dtype == torch.float32
               for t in pm.values())
    assert _rel(float(pm["loss"]), r_metrics["loss"]) <= 1e-5
    assert _rel(float(pm["grad_norm"]), r_metrics["grad_norm"]) <= 1e-4
    assert _rel(float(pm["lr"]), r_metrics["lr"]) <= 1e-6
    assert int(po["count"]) == 1
    for key in ("m", "v"):
        for k, t in _flat(po[key]).items():
            r = r_moments[key][k]
            err = np.abs(_np(t) - r).max()
            assert err <= 1e-4 * np.abs(r).max(), (key, k, err)
    lr = r_metrics["lr"]
    for k, t in _flat(pp).items():
        r, g = r_params[k], np.abs(r_moments["m"][k])
        assert not t.requires_grad and t.grad is None
        strong = g > 1e-3 * g.max()
        bound = np.where(strong, 1e-3 * lr, 2 * lr) + 1e-6 * np.abs(r)
        assert np.all(np.abs(_np(t) - r) <= bound), k
        assert not np.array_equal(_np(t), start[k]), k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_train_step_matches_reference(arch):
    cfg = _cfg(arch, "bfloat16")
    _, _, r_metrics = _ref_step(arch, "bfloat16")
    params = _port_params(arch, "bfloat16")
    pp, po, pm = build_train_step(cfg, **STEP)(params, adamw_init(params),
                                               _batch(cfg), 1)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(pp))
    assert all(t.dtype == torch.float32 for t in tree_leaves(po["m"]))
    assert _rel(float(pm["loss"]), r_metrics["loss"]) <= 2e-2
    assert _rel(float(pm["grad_norm"]), r_metrics["grad_norm"]) <= 5e-2


# ---------------------------------------------------------------------------
# a short run
# ---------------------------------------------------------------------------
def test_five_step_run_matches_reference():
    """Five steps of reduced olmo on five batches: the loss trajectory
    within rel 1e-3 of the reference's."""
    cfg = _cfg("olmo_1b")
    batches = [_batch(cfg, seed) for seed in range(5)]
    r_fn = jax.jit(r_build_train_step(cfg, base_lr=1e-2, warmup_steps=1,
                                      total_steps=5))
    params = _jx(_weights("olmo_1b", "float32"))
    opt = r_adamw_init(params)
    ref = []
    for i, b in enumerate(batches):
        params, opt, m = r_fn(params, opt, _jx(b), i)
        ref.append(float(m["loss"]))
    step = build_train_step(cfg, base_lr=1e-2, warmup_steps=1,
                            total_steps=5)
    params = _port_params("olmo_1b")
    opt = adamw_init(params)
    port = []
    for i, b in enumerate(batches):
        params, opt, m = step(params, opt, b, i)
        port.append(float(m["loss"]))
    assert ref[-1] < ref[0]
    np.testing.assert_allclose(port, ref, rtol=1e-3)
