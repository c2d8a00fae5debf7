"""chip_smoke's card-vs-CPU gradient check on the CPU: check_grads with
made-up gradients (the card within GRAD_BAR of the CPU passes; beyond it,
within CPU_ERR_FACTOR x the CPU's float32 error against float64, capped at
ERR_CAP), and the branch replay of the reference runs (Branches: each |x|,
leaky ReLU, ReLU and clamp on the recorded side of its kink; CardUpdate:
D's update taken from the card's run), with flips counted and bounded by
BRANCH_FLIP_SHARE."""

import pytest
import torch
import torch.nn.functional as F

import chip_smoke as c


def _grads(scale: float, seed: int, n: int = 200) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {f"t{i}": 1.0 + scale * torch.randn(64, generator=g, dtype=torch.float64) for i in range(n)}


EXACT = {f"t{i}": torch.ones(64, dtype=torch.float64) for i in range(200)}


def test_within_the_bar_and_within_ten_times_the_cpu_error():
    rec = c.check_grads(_grads(1e-5, 1), _grads(1e-5, 2), EXACT, "t")
    assert rec["within_bar"] == 200 and not rec["held_by_f64"]
    card, cpu = _grads(1e-5, 1), _grads(1e-5, 2)
    card["t0"], cpu["t0"] = _grads(2e-3, 4)["t0"], _grads(1e-3, 5)["t0"]
    rec = c.check_grads(card, cpu, EXACT, "t")
    assert list(rec["held_by_f64"]) == ["t0"]


def test_beyond_ten_times_the_cpu_error_or_the_cap_fails():
    card, cpu = _grads(1e-5, 1), _grads(1e-5, 2)
    card["t0"] = _grads(2e-3, 4)["t0"]  # the CPU's float32 run is far closer to float64
    with pytest.raises(AssertionError):
        c.check_grads(card, cpu, EXACT, "t")
    card, cpu = _grads(1e-5, 1), _grads(1e-5, 2)
    card["t0"], cpu["t0"] = _grads(0.2, 4)["t0"], _grads(0.1, 5)["t0"]  # within 10x, beyond ERR_CAP
    with pytest.raises(AssertionError):
        c.check_grads(card, cpu, EXACT, "t")


def _kinked(w: torch.Tensor, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    h = F.leaky_relu(x @ w, 0.1)
    h = torch.relu(h - 0.5) + torch.clamp(h, min=-0.2)
    return torch.abs(h - t).sum()


def _grad_of(w0, x, t, branches=None):
    w = w0.clone().requires_grad_(True)
    with c.Branches(branches) as br:
        _kinked(w, x, t).backward()
    return w.grad, br


def test_branches_replay_the_recorded_sides():
    g = torch.Generator().manual_seed(0)
    w0 = torch.randn(8, 16, generator=g, dtype=torch.float64)
    x = torch.randn(1024, 8, generator=g, dtype=torch.float64)  # 16384 decisions of each kind
    t = torch.randn(1024, 16, generator=g, dtype=torch.float64)
    grad_rec, rec = _grad_of(w0, x, t)
    assert [k for k, _ in rec.log] == ["leaky_relu", "relu", "clamp", "abs"]
    saved = (torch.abs, F.leaky_relu, torch.relu, torch.clamp)
    # one target a hair across from h: that |h - t| takes the other side of its kink
    h = F.leaky_relu(x @ w0, 0.1)
    h = torch.relu(h - 0.5) + torch.clamp(h, min=-0.2)
    t2 = t.clone()
    t2[3, 5] = h[3, 5] + 1e-12 * torch.sign(h[3, 5] - t[3, 5])
    grad_own, _ = _grad_of(w0, x, t2)
    grad_rep, br = _grad_of(w0, x, t2, rec)
    assert br.check("t") == {"leaky_relu": [0, 16384], "relu": [0, 16384], "clamp": [0, 16384], "abs": [1, 16384]}
    assert (grad_own - grad_rec).abs().max() > 0.1  # the kink's full jump
    assert torch.equal(grad_rep, grad_rec)
    assert (torch.abs, F.leaky_relu, torch.relu, torch.clamp) == saved  # restored on exit


def test_branches_check_bounds_the_flips_and_wants_every_decision():
    g = torch.Generator().manual_seed(1)
    w0 = torch.randn(8, 16, generator=g)
    x, t = torch.randn(32, 8, generator=g), torch.randn(32, 16, generator=g)
    _, rec = _grad_of(w0, x, t)
    _, br = _grad_of(w0, -x, t, rec)  # another input: a large share of the sides differ
    with pytest.raises(AssertionError):
        br.check("t")
    w = w0.clone().requires_grad_(True)
    with c.Branches(rec) as short:
        F.leaky_relu(x @ w, 0.1).sum().backward()  # one decision of the four replayed
    with pytest.raises(AssertionError, match="branches replayed"):
        short.check("t")
    with torch.no_grad(), c.Branches() as none:  # no gradient, nothing recorded
        _kinked(w0, x, t)
    assert none.log == []


def _step(module, opt, x):
    opt.zero_grad()
    (module(x) ** 2).sum().backward()
    opt.step()


def test_card_update_takes_the_cards_weights_and_counts_flips():
    torch.manual_seed(2)
    card = torch.nn.Linear(16, 8)
    before = c.params_after(card)
    x = torch.randn(4, 16)
    _step(card, torch.optim.AdamW(card.parameters(), lr=1e-3, eps=1e-9), x)
    after = c.params_after(card)

    def reference(target):
        ref = torch.nn.Linear(16, 8).double()
        ref.load_state_dict({n: v.double() for n, v in before.items()})
        upd = c.CardUpdate(torch.optim.AdamW(ref.parameters(), lr=1e-3, eps=1e-9), ref, target)
        _step(ref, upd, x.double())
        return ref, upd

    ref, upd = reference(after)
    assert upd.check("t") == [0, 136]  # its own update is the card's
    for n, p in ref.named_parameters():
        assert torch.equal(p, after[n].double()), n
    _, upd = reference({n: 2 * before[n] - v for n, v in after.items()})  # a card that stepped the other way
    assert upd.flips == 136
    with pytest.raises(AssertionError):
        upd.check("t")
