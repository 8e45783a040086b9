"""Each reference agrees with ``repro_torch`` at a tiny size in float32:
the same model function, the same optimizer step."""
import pytest
import torch

from portbench.calibrate import readings
from portbench.harness import inputs
from portbench.reference.adamw import AdamW
from portbench.tests import tiny

CELLS = ["olmo-1b.train-8x2048", "granite-moe-1b.train-16x1024",
         "olmo-1b.prefill-8x2048"]
# float32 on both sides, two programs of one function: only the order of
# the sums differs (1e-6 relative reads ~1e-7 here)
TOL = 1e-5


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_port(name):
    c = tiny.cell(name)
    rec = next(readings(c, torch.device("cpu"), [20241018], [], [], 0.05))
    numbers = {k: v for k, v in rec.items() if k.endswith("_gap")}
    assert numbers and max(numbers.values()) < TOL, numbers


def test_reference_adamw_is_the_ports():
    from repro_torch.optim import adamw_init, adamw_update
    gen = torch.Generator().manual_seed(7)
    shapes = {"a": (4, 6), "b": (6,), "c": (2, 3, 5)}
    params = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    grads = [{k: 3 * torch.randn(s, generator=gen) for k, s in shapes.items()}
             for _ in range(3)]
    hyper = {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
             "max_grad_norm": 1.0}
    mine = {k: v.clone() for k, v in params.items()}
    ref = AdamW(mine, hyper)
    theirs = {k: v.clone() for k, v in params.items()}
    state = adamw_init(theirs)
    for g in grads:
        clipped, norm = AdamW.clip(g, 1.0)
        ref.step(clipped, 3e-2)
        theirs, state, m = adamw_update(g, state, theirs, 3e-2)
        assert abs(float(m["grad_norm"]) - float(norm)) < 1e-5
    for k in shapes:
        torch.testing.assert_close(mine[k], theirs[k], rtol=1e-6, atol=1e-6)


def test_inputs_repeat_from_the_seed():
    c = tiny.cell("olmo-1b.train-8x2048", "bfloat16")
    seed = 2**31 + 12345
    a = inputs.make_weights(c.arch, seed, "cpu")
    b = inputs.make_weights(c.arch, seed, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    t1 = inputs.make_tokens(c.arch, c.traffic, seed, "cpu")
    t2 = inputs.make_tokens(c.arch, c.traffic, seed, "cpu")
    assert torch.equal(t1, t2) and int(t1.max()) < c.arch["text_vocab"]
    rows = t1.reshape(-1, t1.shape[-1])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
    other = inputs.make_tokens(c.arch, c.traffic, seed + 1, "cpu")
    assert not torch.equal(t1, other)
