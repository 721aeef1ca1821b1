"""AQUA-PLACER in the port (``repro_torch/core/placer.py``) against the JAX
reference's ``repro/core/placer.py``: the paper's Fig. 4 placement,
branch-and-bound against brute force under hypothesis (as
``test_aqua_core.py:150``), the same assignment, objective and pairs as the
reference for ``bnb``, ``greedy`` and ``milp`` on the same draws, the
128-GPU instance of the paper's appendix within 45 s, and ``place``
raising on more models than GPUs."""
import itertools

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import placer as J
from repro_torch.core import placer as T


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(mod, draws):
    return [mod.ModelSpec(name, mem, kind) for name, mem, kind in draws]


def test_placer_matches_paper_fig4():
    models = _specs(T, [("sd-0", 30, "producer"), ("sd-1", 30, "producer"),
                        ("llm-0", -25, "consumer"),
                        ("llm-1", -25, "consumer")])
    p = T.place(models, 2, 2, 80.0, solver="bnb")
    for s, ms in p.servers().items():
        assert sorted(m.split("-")[0] for m in ms) == ["llm", "sd"]
    assert len(p.pairs) == 2
    assert p.solver == "bnb"


@settings(max_examples=15, deadline=None)
@given(st.integers(2, 4), st.integers(2, 3), st.data())
def test_placer_bnb_is_optimal_vs_bruteforce(S, G, data):
    M = data.draw(st.integers(2, min(6, S * G)))
    models = []
    for i in range(M):
        kind = data.draw(st.sampled_from(["producer", "consumer"]))
        mem = data.draw(st.sampled_from([10.0, 25.0, 40.0]))
        models.append(T.ModelSpec(f"m{i}", mem if kind == "producer"
                                  else -mem, kind))
    p = T.place(models, S, G, 80.0, solver="bnb")
    best = min(T._objective(models, a, S, 80.0)
               for a in itertools.product(range(S), repeat=M)
               if max(np.bincount(a, minlength=S)) <= G)
    assert p.objective <= best + 1e-9


def _draws(seed):
    """A random cluster: 2-4 servers of 2-4 GPUs, up to every slot taken
    by producers and consumers of 5-60 GB."""
    rng = np.random.default_rng(seed)
    S, G = int(rng.integers(2, 5)), int(rng.integers(2, 5))
    M = int(rng.integers(2, min(8, S * G) + 1))
    draws = []
    for i in range(M):
        kind = ("producer", "consumer")[int(rng.integers(0, 2))]
        mem = float(rng.choice([5.0, 10.0, 25.0, 30.0, 40.0, 60.0]))
        draws.append((f"m{i}", mem if kind == "producer" else -mem, kind))
    return S, G, draws


@pytest.mark.parametrize("solver", ["bnb", "greedy", "milp", "auto"])
@pytest.mark.parametrize("seed", range(6))
def test_place_equals_reference(solver, seed):
    S, G, draws = _draws(seed)
    got = T.place(_specs(T, draws), S, G, 80.0, solver=solver)
    want = J.place(_specs(J, draws), S, G, 80.0, solver=solver)
    assert got.assignment == want.assignment
    assert got.objective == want.objective
    assert got.pairs == want.pairs
    assert got.solver == want.solver
    assert got.servers() == want.servers()
    if solver in ("milp", "auto"):
        assert got.solver == "milp"


@pytest.mark.parametrize("exc", [ImportError, ValueError, RuntimeError])
def test_milp_falls_back_to_bnb(exc, monkeypatch):
    def broken(*args):
        raise exc("no solver")
    monkeypatch.setattr(T, "_solve_milp", broken)
    S, G, draws = _draws(0)
    got = T.place(_specs(T, draws), S, G, 80.0, solver="milp")
    want = J.place(_specs(J, draws), S, G, 80.0, solver="bnb")
    assert got.solver == "bnb"
    assert (got.assignment, got.objective, got.pairs) == \
        (want.assignment, want.objective, want.pairs)


def test_objective_and_matching_equal_reference():
    for seed in range(6):
        S, G, draws = _draws(seed)
        rng = np.random.default_rng(100 + seed)
        assign = [int(rng.integers(0, S)) for _ in draws]
        assert T._objective(_specs(T, draws), assign, S, 80.0) == \
            J._objective(_specs(J, draws), assign, S, 80.0)
        assert T._match_within_servers(_specs(T, draws), assign, S) == \
            J._match_within_servers(_specs(J, draws), assign, S)


def test_placer_scales_to_128_gpus_quickly():
    models = []
    for i in range(42):
        models.append(T.ModelSpec(f"img{i}", 30.0, "producer"))
        models.append(T.ModelSpec(f"aud{i}", 40.0, "producer"))
        models.append(T.ModelSpec(f"llm{i}", -35.0, "consumer"))
    p = T.place(models, 16, 8, 80.0, solver="greedy")
    assert p.solve_time < 45.0
    assert len(p.assignment) == 126


def test_place_raises_on_too_many_models():
    models = [T.ModelSpec(f"m{i}", 10.0, "producer") for i in range(5)]
    with pytest.raises(ValueError):
        T.place(models, 2, 2, 80.0)
    with pytest.raises(ValueError):
        T.place(models[:4], 2, 2, 80.0, solver="nope")
    with pytest.raises(ValueError):
        T._solve_greedy(models, 2, 2, 80.0)
