"""Plain reference of the reuse layer: a fleet of replicas behind a router,
each with a Content Store and an LSH-indexed reuse store at capacity.

NumPy, and plain torch for the hash's products and sorts, in float64, written from the semantics that the configuration
states (paper §IV; the deployment of ``configs/*.json``) and importing
nothing of the program:

- LSH: FALCONN's cross-polytope family, one random rotation a table drawn by
  ``default_rng(seed)`` and orthogonalised by QR (the deployment's LSH seed
  defines the rotations); a table's bucket is the first maximum of
  ``concat(R x, -R x)``; multi-probe visits the ``num_probes`` highest
  vertices.  The task's name is its bucket in every table.
- Router: consecutive bucket ranges, ``round(i * E / R)``, one a replica;
  a task goes to the replica that most tables vote for, ties to the lower.
- Replica, for its share of a round in submission order: an exact-name
  Content Store hit (LRU, refreshed on a hit); else a follower of an earlier
  task of the same name in the round, which gets that task's result; else
  one query of the store as it stood when the round's share arrived: the
  highest cosine among the live entries in the probed buckets, reused when it
  reaches the threshold (the entry's LRU position refreshed, the name cached
  with the result); else an execution, inserted (the least recently used
  entry evicted at capacity) and cached.
- Bucket rows hold ``bucket_cap`` ids; a full row overwrites its ring
  position (the cursor advances), a removal moves the row's last id into the
  gap.

``Fleet.judge_round`` holds the program's answers to these rules.  The
buckets the router and each replica computed are answers too: each is held
to the hash (a vertex may be one whose score lies within ``EPS_HASH`` of the
highest, where float32 and float64 can order them either way) and then
followed, so that names and table rows stay the program's.  A probe vertex
within ``EPS_HASH`` of the last probed one may or may not have been probed,
and a cosine within ``EPS_SIM`` of the threshold or of the best may compare
either way: either side is accepted.  ``Fleet.decide_round`` answers a round
itself, in float64 or, for the control, with every product's inputs rounded
to TF32.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

EPS_HASH = 1e-5     # vertex scores closer than this may order either way
EPS_SIM = 1e-5      # cosines closer than this may compare either way


def tf32(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest even)."""
    a = np.ascontiguousarray(x, np.float32).view(np.uint32)
    a = (a + np.uint32(0x0FFF) + ((a >> np.uint32(13)) & np.uint32(1))) & np.uint32(0xFFFFE000)
    return a.view(np.float32)


def rotations(lsh: Mapping) -> np.ndarray:
    """(T, D, D) cross-polytope rotations of the deployment's LSH seed."""
    if lsh["family"] != "cross_polytope" or lsh.get("rotations_per_table", 1) != 1:
        raise ValueError("the reference covers cross-polytope LSH with one rotation a table")
    rng = np.random.default_rng(lsh["seed"])
    d, t = lsh["dim"], lsh["num_tables"]
    raw = rng.standard_normal((t, 1, d, d)).astype(np.float32)
    out = []
    for i in range(t):
        q, r = np.linalg.qr(raw[i, 0])
        out.append((q * np.sign(np.diag(r))).astype(np.float32))
    return np.stack(out)


def unit(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


WINDOW = 4   # vertices past the probes that the near-tie tests look at


@dataclasses.dataclass
class Hashed:
    """A batch's LSH view: each table's highest vertices (in order, as
    buckets) and their scores."""
    top: np.ndarray      # (N, T, P + WINDOW) buckets, highest first
    val: np.ndarray      # (N, T, P + WINDOW) their scores
    p: int

    @property
    def buckets(self) -> np.ndarray:
        """(N, T) canonical buckets: the name."""
        return self.top[..., 0]

    def allows(self, buckets: np.ndarray) -> np.ndarray:
        """(N,) whether each row of (N, T) buckets is a hash of its task:
        in every table a vertex whose score lies within ``EPS_HASH`` of the
        highest."""
        near = self.val >= self.val[..., :1] - EPS_HASH
        return ((self.top == buckets[..., None]) & near).any(axis=-1).all(axis=-1)

    def probes(self, i: int) -> List[Tuple[int, ...]]:
        return [tuple(int(b) for b in self.top[i, t, :self.p]) for t in range(self.top.shape[1])]

    def probe_sure(self, i: int) -> List[Tuple[int, ...]]:
        v, p = self.val[i], self.p
        return [tuple(int(b) for b in self.top[i, t][v[t] > v[t, p] + EPS_HASH])
                for t in range(v.shape[0])]

    def probe_maybe(self, i: int) -> List[Tuple[int, ...]]:
        v, p = self.val[i], self.p
        return [tuple(int(b) for b in self.top[i, t][v[t] >= v[t, p - 1] - EPS_HASH])
                for t in range(v.shape[0])]


class Lsh:
    """The deployment's LSH in float64 (or, for the control, from TF32-rounded
    inputs), its products and sorts run with torch on ``device``."""

    def __init__(self, lsh: Mapping, precision: str = "f64", device: str = "cpu"):
        self.cfg = lsh
        self.t, self.p, self.nb = lsh["num_tables"], lsh["num_probes"], lsh["num_buckets"]
        self.precision = precision
        self.device = torch.device(device)
        rot = rotations(lsh)
        self.rot = (tf32(rot) if precision == "tf32" else rot).astype(np.float64)
        t, d, _ = self.rot.shape
        self._rot_t = torch.from_numpy(self.rot.reshape(t * d, d).T.copy()).to(self.device)
        self.effective = min(self.nb, 2 * lsh["dim"])

    def hash(self, x: np.ndarray, chunk: int = 65536) -> Hashed:
        """The highest vertices of ``concat(R x, -R x)``.  Of each pair
        (+e_i, -e_i) one is at least 0, so the highest vertices are the
        largest |(R x)_i|, vertex i or i + D by the sign."""
        if self.precision == "tf32":
            x = tf32(x.astype(np.float32)).astype(np.float64)
        k, (t, d, _) = self.p + WINDOW, self.rot.shape
        tops, vals = [], []
        for lo in range(0, x.shape[0], chunk):
            xc = torch.from_numpy(np.ascontiguousarray(x[lo:lo + chunk], np.float64))
            p = (xc.to(self.device) @ self._rot_t).reshape(-1, t, d)
            a, top = torch.sort(p.abs(), dim=-1, descending=True, stable=True)
            top = top[..., :k]
            vert = top + d * (p.gather(-1, top) < 0)
            tops.append((vert % self.nb).cpu().numpy())
            vals.append(a[..., :k].cpu().numpy())
        if not tops:
            z = np.zeros((0, self.t, k))
            return Hashed(z.astype(np.int64), z, self.p)
        return Hashed(np.concatenate(tops), np.concatenate(vals), self.p)

    def owners(self, buckets: np.ndarray, replicas: int) -> np.ndarray:
        """(N,) replicas of (N, T) names: each table votes for the range its
        bucket lies in; the most votes win, ties to the lower replica."""
        bounds = np.asarray([round(i * self.effective / replicas)
                             for i in range(replicas + 1)][1:-1])
        o = np.minimum(np.searchsorted(bounds, buckets, side="right"), replicas - 1)
        votes = (o[..., None] == np.arange(replicas)).sum(axis=-2)
        return votes.argmax(axis=-1)


class Replica:
    """One replica's Content Store and reuse store."""

    def __init__(self, dep: Mapping, t: int, nb: int, n_max: int, dim: int,
                 rounded: bool = False):
        self.capacity = dep["store_capacity"]
        self.cap = dep["bucket_cap"]
        self.cs_capacity = dep["cs_capacity"]
        self.cs: "OrderedDict[Tuple[int, ...], Any]" = OrderedDict()   # name -> result
        self.emb = np.zeros((n_max, dim), np.float64)
        # the control's TF32 copy of each row (``rounded``), kept beside it
        self.emb_q = np.zeros((n_max, dim), np.float64) if rounded else self.emb
        self.alive = np.zeros(n_max, bool)
        self.result: List[Any] = [None] * n_max
        self.buckets: List[Optional[Tuple[int, ...]]] = [None] * n_max
        self.by_key: Dict[Any, int] = {}
        self.n = 0
        self.lru: "OrderedDict[int, None]" = OrderedDict()
        self.slots = np.full((t, nb, self.cap), -1, np.int64)
        self.fill = [[0] * nb for _ in range(t)]
        self.cursor = [[0] * nb for _ in range(t)]

    def cs_insert(self, name: Tuple[int, ...], result: Any) -> None:
        self.cs.pop(name, None)
        self.cs[name] = result
        while len(self.cs) > self.cs_capacity:
            self.cs.popitem(last=False)

    # ----------------------------------------------------------- tables
    def _row_add(self, t: int, b: int, idx: int) -> None:
        f = self.fill[t][b]
        if f < self.cap:
            self.slots[t, b, f] = idx
            self.fill[t][b] = f + 1
        else:   # a full row: overwrite the ring position
            c = self.cursor[t][b]
            self.slots[t, b, c] = idx
            self.cursor[t][b] = (c + 1) % self.cap

    def _row_remove(self, t: int, b: int, idx: int) -> None:
        f = self.fill[t][b]
        row = self.slots[t, b]
        pos = np.nonzero(row[:f] == idx)[0]
        if pos.size:   # absent where a full row overwrote it
            p = int(pos[0])
            row[p] = row[f - 1]
            row[f - 1] = -1
            self.fill[t][b] = f - 1

    def insert(self, emb: np.ndarray, key: Any, result: Any, name: Tuple[int, ...]) -> None:
        while len(self.lru) >= self.capacity:
            old, _ = self.lru.popitem(last=False)
            for t, b in enumerate(self.buckets[old]):
                self._row_remove(t, b, old)
            self.alive[old] = False
            self.by_key.pop(entry_key(self.result[old]), None)
        idx = self.n
        self.n += 1
        self.emb[idx] = emb
        if self.emb_q is not self.emb:
            self.emb_q[idx] = tf32(emb.astype(np.float32))
        self.alive[idx] = True
        self.result[idx] = result
        self.by_key[key] = idx
        self.buckets[idx] = name
        for t, b in enumerate(name):
            self._row_add(t, b, idx)
        self.lru[idx] = None

    def fill_empty(self, emb: np.ndarray, results: List[Any], names: np.ndarray) -> None:
        """Entries inserted in order into the empty store, no more than its
        capacity, and their names cached in order: each row keeps its
        bucket's entries in order, and where a bucket had more than
        ``bucket_cap``, its last ``bucket_cap``, entry k at ring position
        k mod cap (the cursor past the last); the Content Store keeps the
        last ``cs_capacity`` distinct names."""
        n, cap = len(results), self.cap
        if self.n or n > self.capacity:
            raise ValueError("fill_empty takes an empty store, up to its capacity")
        self.emb[:n] = emb
        if self.emb_q is not self.emb:
            self.emb_q[:n] = tf32(emb.astype(np.float32))
        self.alive[:n] = True
        self.result[:n] = results
        self.by_key.update(zip(map(entry_key, results), range(n)))
        tuples = list(map(tuple, names.tolist()))
        self.buckets[:n] = tuples
        self.lru = OrderedDict.fromkeys(range(n))
        self.n = n
        for t in range(names.shape[1]):
            order = np.argsort(names[:, t], kind="stable")
            uniq, starts, counts = np.unique(names[order, t], return_index=True,
                                             return_counts=True)
            for b, s0, c in zip(uniq.tolist(), starts.tolist(), counts.tolist()):
                ids = order[s0:s0 + c]
                if c <= cap:
                    self.slots[t, b, :c] = ids
                    self.fill[t][b] = c
                else:
                    self.slots[t, b, np.arange(c - cap, c) % cap] = ids[c - cap:]
                    self.fill[t][b], self.cursor[t][b] = cap, (c - cap) % cap
        last: Dict[Tuple[int, ...], int] = {}
        for i in range(n - 1, -1, -1):
            if tuples[i] not in last:
                last[tuples[i]] = i
                if len(last) == self.cs_capacity:
                    break
        for name, i in sorted(last.items(), key=lambda kv: kv[1]):
            self.cs_insert(name, results[i])

    # ----------------------------------------------------------- queries
    def ids(self, probes: List[Tuple[int, ...]]) -> np.ndarray:
        """The ids in the probed rows, as often as they appear (rows hold
        only live ids)."""
        parts = [self.slots[t, b, :self.fill[t][b]] for t, bs in enumerate(probes) for b in bs]
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)

    def rows(self, probes: List[Tuple[int, ...]]) -> np.ndarray:
        """The distinct ids in the probed rows, sorted."""
        return np.unique(self.ids(probes))

    def best(self, sims: np.ndarray, probes: List[Tuple[int, ...]]) -> float:
        """The highest of ``sims`` (one per entry) over the probed rows."""
        ids = self.ids(probes)
        return float(sims[ids].max()) if ids.size else -np.inf


def entry_key(result: Any) -> Any:
    """What names an entry: a fill entry's result is its key; an execution's
    is (task id, token), named by the task."""
    return ("task", result[0]) if isinstance(result, tuple) else ("fill", result)


@dataclasses.dataclass
class Answer:
    """A task's answer: its replica, kind ("cs", "en" or None: executed),
    result and reported similarity."""
    replica: int
    kind: Optional[str]
    result: Any
    sim: float


class Fleet:
    """The reference fleet; ``n_max`` bounds the entries a replica makes.
    ``precision`` is "f64" (the reference) or "tf32" (the control's
    arithmetic, for ``decide_round``)."""

    def __init__(self, dep: Mapping, n_max: int, precision: str = "f64", device: str = "cpu"):
        self.dep = dep
        self.lsh = Lsh(dep["lsh"], precision, device)
        self.precision = precision
        self.r = dep["replicas"]
        self.thr = dep["threshold"]
        self.replicas = [Replica(dep, self.lsh.t, self.lsh.nb, n_max, dep["lsh"]["dim"],
                                 rounded=precision == "tf32") for _ in range(self.r)]
        self.wrong: Dict[str, int] = {}
        self.examples: List[str] = []
        self.checked = 0        # answers held to the rules
        self.full_checked = 0   # of them, store answers checked against the candidates

    def _fault(self, kind: str, what: str) -> None:
        self.wrong[kind] = self.wrong.get(kind, 0) + 1
        if len(self.examples) < 5:
            self.examples.append(f"{kind}: {what}")

    @property
    def n_wrong(self) -> int:
        return sum(self.wrong.values())

    def _routing(self, h: Hashed, route: np.ndarray, replicas: np.ndarray, what: str) -> None:
        """Hold the router's buckets to the hash and its replicas to the
        ranges' vote."""
        for i in np.nonzero(~h.allows(route))[0]:
            self._fault("hash", f"{what} {i}: router buckets {route[i].tolist()}")
        for i in np.nonzero(self.lsh.owners(route, self.r) != replicas)[0]:
            self._fault("owner", f"{what} {i} went to replica {replicas[i]}")

    # ----------------------------------------------------------------- fill
    def fill(self, x: np.ndarray, owners: np.ndarray, buckets: np.ndarray,
             keys: Sequence[Any]) -> None:
        """The store fill: rows ``x`` routed to ``owners`` under ``buckets``
        (the router's answers, held to the rules), each replica taking its
        first ``store_capacity`` rows in order, each cached under its name."""
        xu = unit(x)
        self._routing(self.lsh.hash(xu), buckets, owners, "fill row")
        for r, rep in enumerate(self.replicas):
            idx = np.nonzero(owners == r)[0][:rep.capacity]
            rep.fill_empty(xu[idx], [keys[i] for i in idx.tolist()], buckets[idx])

    # ---------------------------------------------------------------- rounds
    def decide_round(self, x: np.ndarray, task_ids: Sequence[int], execute
                     ) -> Tuple[List[Answer], np.ndarray]:
        """Answer a round by the rules in this fleet's precision and carry
        the answers on.  ``execute(task_ids) -> results`` stands for the
        model.  -> (answers, the (N, T) names it gave the tasks)."""
        xu = unit(x)
        h = self.lsh.hash(xu)
        names = h.buckets
        owners = self.lsh.owners(names, self.r)
        q = tf32(xu.astype(np.float32)).astype(np.float64) if self.precision == "tf32" else xu
        answers: List[Optional[Answer]] = [None] * len(xu)
        for r in range(self.r):
            rep = self.replicas[r]
            leaders: Dict[Tuple[int, ...], int] = {}
            pending, misses = [], []
            for i in np.nonzero(owners == r)[0].tolist():
                name = tuple(names[i].tolist())
                if name in rep.cs:
                    rep.cs.move_to_end(name)
                    answers[i] = Answer(r, "cs", rep.cs[name], 1.0)
                elif name in leaders:
                    answers[i] = Answer(r, "follow", leaders[name], 1.0)
                else:
                    leaders[name] = i
                    pending.append(i)
            for i in pending:
                ids = rep.rows(h.probes(i))
                if ids.size:
                    sims = rep.emb_q[ids] @ q[i]
                    j = int(np.argmax(sims))
                    if sims[j] >= self.thr:
                        answers[i] = Answer(r, "en", rep.result[ids[j]], float(sims[j]))
                        continue
                misses.append(i)
            for i, res in zip(misses, execute([task_ids[i] for i in misses])):
                answers[i] = Answer(r, None, res, -1.0)
            self._carry(rep, pending, xu, names, answers)
        for i, a in enumerate(answers):
            if a.kind == "follow":
                answers[i] = Answer(a.replica, "cs", answers[a.result].result, 1.0)
        return answers, names

    def judge_round(self, x: np.ndarray, task_ids: Sequence[int],
                    answers: Sequence[Optional[Answer]], route: np.ndarray,
                    names: np.ndarray, full: bool) -> None:
        """Hold one round's answers to the rules and carry them on.
        ``route``: the router's (N, T) buckets; ``names``: each replica's
        (N, T) buckets for its tasks.  With ``full`` each store answer is
        checked against the probed candidates; without, what the state alone
        decides: routing, names, the Content Store, followers, that a reused
        entry lives and that an execution's result is its own."""
        xu = unit(x)
        h = self.lsh.hash(xu)
        replicas = np.asarray([-1 if a is None else a.replica for a in answers])
        answered = replicas >= 0
        for i in np.nonzero(~answered)[0]:
            self._fault("missing", f"task {task_ids[i]} has no answer")
        self._routing(h, route, replicas, "task")
        for i in np.nonzero(answered & ~h.allows(names))[0]:
            self._fault("hash", f"task {task_ids[i]}: replica buckets {names[i].tolist()}")
        self.checked += len(answers)
        for r in range(self.r):
            idxs = np.nonzero(replicas == r)[0].tolist()
            if idxs:
                self._judge_share(self.replicas[r], idxs, xu, h, names, task_ids, answers, full)

    def _judge_share(self, rep: Replica, idxs: List[int], xu: np.ndarray, h: Hashed,
                     names: np.ndarray, task_ids, answers, full: bool) -> None:
        # 1. Content Store hits, in order; the others lead or follow
        leaders: Dict[Tuple[int, ...], int] = {}
        followers: List[int] = []
        pending: List[int] = []
        for i in idxs:
            a, name = answers[i], tuple(names[i].tolist())
            cached = rep.cs.get(name)
            if a.kind == "cs":
                if name in rep.cs and cached == a.result:
                    rep.cs.move_to_end(name)
                else:
                    followers.append(i)
                continue
            if name in rep.cs:
                self._fault("cs", f"task {task_ids[i]} missed a Content Store hit")
            if name in leaders:
                self._fault("follow", f"task {task_ids[i]} ran beside a task of its name")
            leaders.setdefault(name, i)
            pending.append(i)
        # 2. the store's answers, against the store as the round found it
        asked = [i for i in pending if answers[i].kind in ("en", None)]
        if full and asked:
            sims = rep.emb[:rep.n] @ xu[asked].T          # (entries, asked)
            col = {i: c for c, i in enumerate(asked)}
        for i in pending:
            a = answers[i]
            if a.kind == "en":
                j = rep.by_key.get(entry_key(a.result))
                if j is None or not rep.alive[j] or rep.result[j] != a.result:
                    self._fault("en", f"task {task_ids[i]} reused an entry the store lacks")
                    continue
                if full:
                    s, best = float(sims[j, col[i]]), rep.best(sims[:, col[i]], h.probe_sure(i))
                    if (not (rep.ids(h.probe_maybe(i)) == j).any() or s < self.thr - EPS_SIM
                            or s < best - EPS_SIM or abs(s - a.sim) > EPS_SIM):
                        self._fault("en", f"task {task_ids[i]} reused sim {s:.6f} "
                                          f"(reported {a.sim:.6f}), best {best:.6f}")
            elif a.kind is None:
                if not (isinstance(a.result, tuple) and a.result[0] == task_ids[i]):
                    self._fault("exec", f"task {task_ids[i]} executed, result {a.result!r}")
                if full:
                    best = rep.best(sims[:, col[i]], h.probe_sure(i))
                    if best >= self.thr + EPS_SIM:
                        self._fault("miss", f"task {task_ids[i]} executed beside sim {best:.6f}")
            else:
                self._fault("kind", f"task {task_ids[i]} answered {a.kind!r}")
        if full:
            self.full_checked += len(pending)
        self._carry(rep, pending, xu, names, answers)
        # 4. a follower takes its name's leader's result
        for i in followers:
            j = leaders.get(tuple(names[i].tolist()))
            if j is None or j > i or answers[j].result != answers[i].result:
                self._fault("cs", f"task {task_ids[i]} answered from the Content Store "
                                  "without a name to hit")

    def _carry(self, rep: Replica, pending: List[int], xu: np.ndarray, names: np.ndarray,
               answers) -> None:
        """3. Carry a share's answers on: each reuse refreshes its entry and
        caches its name; then the executions are inserted, then cached."""
        for i in pending:
            a = answers[i]
            if a.kind == "en":
                j = rep.by_key.get(entry_key(a.result))
                if j is not None and rep.alive[j]:
                    rep.lru.move_to_end(j)
                rep.cs_insert(tuple(names[i].tolist()), a.result)
        executed = [i for i in pending if answers[i].kind is None]
        for i in executed:
            rep.insert(xu[i], entry_key(answers[i].result), answers[i].result,
                       tuple(names[i].tolist()))
        for i in executed:
            rep.cs_insert(tuple(names[i].tolist()), answers[i].result)
