"""AQUA-PLACER — optimal model-to-server placement (paper §4, Algorithm 1),
the reference's ``repro/core/placer.py`` kept as the port's own copy (numpy,
plus scipy inside ``_solve_milp``).

Inputs: S servers × G GPUs, models m with memory requirement R_m
(R_m > 0: producer offering memory; R_m < 0: consumer with a deficit — the
paper's sign convention) and type t_m (+1 producer / -1 consumer).

   minimize   max_s(mem_s) + G_mem * max_s(eq_s)
   s.t.       sum_s x_{m,s} = 1            (each model on one server)
              sum_m x_{m,s} <= G           (G GPUs per server)
              mem_s = sum_m x_{m,s} R_m
              eq_s  = sum_m x_{m,s} t_m

Three solvers:
  * ``milp``   — exact, scipy.optimize.milp (HiGHS branch-and-cut).
  * ``bnb``    — exact branch-and-bound over *model-type counts* (models of
                 identical (R, t) are exchangeable, so the state space is the
                 multiset of per-type remaining counts). No solver dependency.
  * ``greedy`` — LPT-style heuristic + pairwise-swap local search for very
                 large clusters; used as the bound seed for ``bnb``.

After server assignment, producers and consumers inside a server are paired
one-to-one by stable matching on memory size (paper: "within each server it
matches producers to consumers using simple stable matching"); a producer's
fabric bandwidth is never shared between consumers.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class ModelSpec:
    name: str
    mem: float          # R_m: + producer / - consumer (GB)
    kind: str           # "producer" | "consumer"

    @property
    def t(self) -> int:
        return 1 if self.kind == "producer" else -1


@dataclass
class Placement:
    assignment: Dict[str, int]               # model -> server
    pairs: List[Tuple[str, str]]             # (consumer, producer) per server
    objective: float
    solve_time: float
    solver: str

    def servers(self) -> Dict[int, List[str]]:
        out: Dict[int, List[str]] = {}
        for m, s in self.assignment.items():
            out.setdefault(s, []).append(m)
        return out


def _objective(models: Sequence[ModelSpec], assign: Sequence[int], S: int,
               g_mem: float) -> float:
    mem = np.zeros(S)
    eq = np.zeros(S)
    for m, s in zip(models, assign):
        mem[s] += m.mem
        eq[s] += m.t
    return float(mem.max() + g_mem * eq.max())


# ---------------------------------------------------------------------------
# exact: scipy MILP (HiGHS)
# ---------------------------------------------------------------------------
def _solve_milp(models: Sequence[ModelSpec], S: int, G: int, g_mem: float):
    from scipy.optimize import LinearConstraint, Bounds, milp
    import scipy.sparse as sp

    M = len(models)
    # variables: x_{m,s} (M*S binaries), z1 (max mem), z2 (max eq)
    nx = M * S
    nv = nx + 2

    def xi(m, s):
        return m * S + s

    c = np.zeros(nv)
    c[nx] = 1.0
    c[nx + 1] = g_mem

    rows, cols, vals, lo, hi = [], [], [], [], []
    r = 0
    for m in range(M):                       # sum_s x = 1
        for s in range(S):
            rows.append(r); cols.append(xi(m, s)); vals.append(1.0)
        lo.append(1.0); hi.append(1.0); r += 1
    for s in range(S):                       # sum_m x <= G
        for m in range(M):
            rows.append(r); cols.append(xi(m, s)); vals.append(1.0)
        lo.append(0.0); hi.append(float(G)); r += 1
    for s in range(S):                       # mem_s - z1 <= 0
        for m in range(M):
            rows.append(r); cols.append(xi(m, s)); vals.append(models[m].mem)
        rows.append(r); cols.append(nx); vals.append(-1.0)
        lo.append(-np.inf); hi.append(0.0); r += 1
    for s in range(S):                       # eq_s - z2 <= 0
        for m in range(M):
            rows.append(r); cols.append(xi(m, s)); vals.append(float(models[m].t))
        rows.append(r); cols.append(nx + 1); vals.append(-1.0)
        lo.append(-np.inf); hi.append(0.0); r += 1

    A = sp.csr_matrix((vals, (rows, cols)), shape=(r, nv))
    integrality = np.concatenate([np.ones(nx), np.zeros(2)])
    bounds = Bounds(np.concatenate([np.zeros(nx), [-np.inf, -np.inf]]),
                    np.concatenate([np.ones(nx), [np.inf, np.inf]]))
    res = milp(c=c, constraints=LinearConstraint(A, lo, hi),
               integrality=integrality, bounds=bounds)
    if not res.success:
        raise RuntimeError(f"milp failed: {res.message}")
    x = res.x[:nx].reshape(M, S)
    assign = [int(np.argmax(x[m])) for m in range(M)]
    return assign


# ---------------------------------------------------------------------------
# exact: branch and bound over type counts (no solver dependency)
# ---------------------------------------------------------------------------
def _solve_bnb(models: Sequence[ModelSpec], S: int, G: int, g_mem: float,
               time_limit: float = 30.0):
    # group exchangeable models
    types: Dict[Tuple[float, int], List[int]] = {}
    for i, m in enumerate(models):
        types.setdefault((m.mem, m.t), []).append(i)
    tkeys = sorted(types, key=lambda k: -abs(k[0]))
    counts0 = tuple(len(types[k]) for k in tkeys)
    T = len(tkeys)

    best = {"obj": _objective(models, _solve_greedy(models, S, G, g_mem), S, g_mem)}
    best_combo: List[Optional[Tuple[Tuple[int, ...], ...]]] = [None]
    t0 = time.monotonic()
    seen = {}

    # enumerate per-server multisets (compositions of counts up to G models)
    def server_options(counts):
        opts = []
        def rec(i, left, cur, mem, eq):
            if i == T:
                opts.append((tuple(cur), mem, eq))
                return
            for n in range(0, min(counts[i], left) + 1):
                cur.append(n)
                rec(i + 1, left - n, cur, mem + n * tkeys[i][0], eq + n * tkeys[i][1])
                cur.pop()
        rec(0, G, [], 0.0, 0)
        return opts

    def rec(s, counts, max_mem, max_eq, chosen):
        if time.monotonic() - t0 > time_limit:
            return
        if s == S:
            if all(c == 0 for c in counts):
                obj = max_mem + g_mem * max_eq
                if obj < best["obj"] - 1e-9:
                    best["obj"] = obj
                    best_combo[0] = tuple(chosen)
            return
        key = (s, counts)
        lb = max_mem + g_mem * max_eq
        if key in seen and seen[key] <= lb + 1e-9:
            return
        seen[key] = lb
        if lb >= best["obj"] - 1e-9:
            return
        remaining_slots = (S - s) * G
        if sum(counts) > remaining_slots:
            return
        for combo, mem, eq in server_options(counts):
            if sum(combo) == 0 and sum(counts) > 0 and (S - s - 1) * G < sum(counts):
                continue
            nc = tuple(c - n for c, n in zip(counts, combo))
            rec(s + 1, nc, max(max_mem, mem), max(max_eq, eq), chosen + [combo])

    rec(0, counts0, -np.inf, -10**9, [])
    if best_combo[0] is None:
        return _solve_greedy(models, S, G, g_mem)
    assign = [0] * len(models)
    pools = {k: list(types[k]) for k in tkeys}
    for s, combo in enumerate(best_combo[0]):
        for ti, n in enumerate(combo):
            for _ in range(n):
                assign[pools[tkeys[ti]].pop()] = s
    return assign


# ---------------------------------------------------------------------------
# heuristic: greedy + local search
# ---------------------------------------------------------------------------
def _solve_greedy(models: Sequence[ModelSpec], S: int, G: int, g_mem: float):
    order = sorted(range(len(models)), key=lambda i: -abs(models[i].mem))
    mem = np.zeros(S)
    eq = np.zeros(S)
    load = np.zeros(S, int)
    assign = [0] * len(models)
    for i in order:
        m = models[i]
        best_s, best_cost = None, None
        for s in range(S):
            if load[s] >= G:
                continue
            nm, ne = mem.copy(), eq.copy()
            nm[s] += m.mem
            ne[s] += m.t
            cost = nm.max() + g_mem * ne.max()
            if best_cost is None or cost < best_cost:
                best_s, best_cost = s, cost
        if best_s is None:
            raise ValueError("more models than GPU slots")
        assign[i] = best_s
        mem[best_s] += m.mem
        eq[best_s] += m.t
        load[best_s] += 1
    # pairwise swap local search
    improved = True
    while improved:
        improved = False
        cur = _objective(models, assign, S, g_mem)
        for i, j in itertools.combinations(range(len(models)), 2):
            if assign[i] == assign[j]:
                continue
            assign[i], assign[j] = assign[j], assign[i]
            if _objective(models, assign, S, g_mem) < cur - 1e-12:
                improved = True
                break
            assign[i], assign[j] = assign[j], assign[i]
    return assign


# ---------------------------------------------------------------------------
# stable matching of producers to consumers inside each server
# ---------------------------------------------------------------------------
def _match_within_servers(models: Sequence[ModelSpec], assign: Sequence[int],
                          S: int) -> List[Tuple[str, str]]:
    pairs = []
    for s in range(S):
        here = [m for m, a in zip(models, assign) if a == s]
        cons = sorted([m for m in here if m.kind == "consumer"], key=lambda m: m.mem)
        prod = sorted([m for m in here if m.kind == "producer"], key=lambda m: -m.mem)
        # largest deficit gets the largest offer (assortative = stable here,
        # since both sides rank strictly by size)
        for c, p in zip(cons, prod):
            pairs.append((c.name, p.name))
    return pairs


def place(models: Sequence[ModelSpec], n_servers: int, gpus_per_server: int,
          gpu_mem: float = 80.0, solver: str = "auto",
          time_limit: float = 30.0) -> Placement:
    if len(models) > n_servers * gpus_per_server:
        raise ValueError("more models than GPUs in the cluster")
    t0 = time.monotonic()
    if solver == "auto":
        solver = "milp" if len(models) * n_servers <= 4096 else "greedy"
    if solver == "milp":
        try:
            assign = _solve_milp(models, n_servers, gpus_per_server, gpu_mem)
        except (ImportError, ValueError, RuntimeError):
            # scipy missing, MILP infeasible, or solver failure: fall back
            # to the exact branch-and-bound — never swallow KeyboardInterrupt
            # or genuine bugs under a blanket handler
            solver = "bnb"
            assign = _solve_bnb(models, n_servers, gpus_per_server, gpu_mem, time_limit)
    elif solver == "bnb":
        assign = _solve_bnb(models, n_servers, gpus_per_server, gpu_mem, time_limit)
    elif solver == "greedy":
        assign = _solve_greedy(models, n_servers, gpus_per_server, gpu_mem)
    else:
        raise ValueError(solver)
    dt = time.monotonic() - t0
    pairs = _match_within_servers(models, assign, n_servers)
    return Placement({m.name: s for m, s in zip(models, assign)}, pairs,
                     _objective(models, assign, n_servers, gpu_mem), dt, solver)
