"""One run of a cell: the port's serving fleet, built as
``launch/serve.py::main`` builds it, driven in a closed lockstep loop.

Set-up: the kernels' libraries (built on a checkout's first run), the
cell's traffic, the model with the benchmark's weights, two replicas
behind the router with their stores filled to capacity through
``commit_execution`` on the replica the router picks (a history of earlier
executions), then a few warm rounds of the cell's own traffic.  The window:
round after round, every client's next task submitted together through
``ServingFleet.submit_batch_sync``; a task completes when the call that
delivers it returns.  Only whole rounds count, so the window ends with the
first round that ends at or after ``seconds``.

The executor is ``make_executor(model, prompt_tokens)``, wrapped so that a
result names the task that made it, ``(task id, token)``, and so that the
last-position logits of a seeded sample of executed tasks are kept (the
model's ``prefill`` is wrapped on the instance; the program is not edited).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from bench.spec import Cell
from bench.traffic import Traffic, prompts, sample_mask
from bench.weights import Weights

PROMPT_POOL = 16384            # distinct prompts; task i sends prompt i % pool
FILL_FACTOR = 2.5              # history rows routed a replica's capacity, at first
SERVING_LIBS = ("lsh_hash", "reuse_probed", "sim_topk", "flash_attention")
SIZE_KEYS = ("hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
             "num_key_value_heads", "head_dim", "vocab_size", "rope_theta", "rms_norm_eps",
             "tie_word_embeddings", "attention_bias", "qk_norm", "torch_dtype", "hidden_act")


def arch_sizes(arch) -> Dict[str, Any]:
    """The program's ``ArchConfig`` under the configuration files' keys."""
    return {"hidden_size": arch.d_model, "intermediate_size": arch.d_ff,
            "num_hidden_layers": arch.n_layers, "num_attention_heads": arch.n_heads,
            "num_key_value_heads": arch.n_kv_heads, "head_dim": arch.resolved_head_dim,
            "vocab_size": arch.vocab_size, "rope_theta": arch.rope_theta,
            "rms_norm_eps": arch.norm_eps, "tie_word_embeddings": arch.tie_embeddings,
            "attention_bias": arch.qkv_bias, "qk_norm": arch.qk_norm,
            "torch_dtype": arch.dtype, "hidden_act": arch.mlp_act}


KINDS = {"cs": 0, "en": 1, None: 2}    # a ServeResult's reuse; -1: no result


@dataclasses.dataclass
class Round:
    """One round's answers, kept as arrays: the harness holds every round
    for the check, and as objects they would load the collector."""
    index: int                  # row of the traffic
    seconds: float              # submit to return
    warm: bool
    replica: np.ndarray
    kind: np.ndarray
    key: np.ndarray             # a fill entry's key, or the task that executed
    token: np.ndarray           # the executed token; -1 for a fill entry
    sim: np.ndarray
    route: np.ndarray = None    # (N, T) buckets the router computed
    names: np.ndarray = None    # (N, T) buckets each replica named its task by

    @classmethod
    def of(cls, index: int, seconds: float, results: List[Any], warm: bool) -> "Round":
        n = len(results)
        rep, kind = np.full(n, -1, np.int64), np.full(n, -1, np.int8)
        key, token, sim = np.full(n, -1, np.int64), np.full(n, -1, np.int64), np.zeros(n)
        for i, r in enumerate(results):
            if r is None:
                continue
            rep[i], kind[i], sim[i] = r.replica, KINDS.get(r.reuse, -1), r.similarity
            if isinstance(r.result, tuple) and len(r.result) == 2:
                key[i], token[i] = r.result
            elif isinstance(r.result, (int, np.integer)):
                key[i] = r.result
        return cls(index, seconds, warm, rep, kind, key, token, sim)

    def __len__(self) -> int:
        return len(self.kind)

    def results(self) -> List[Optional[tuple]]:
        """(replica, reuse, result, similarity) of each task, None where
        none came back."""
        names = {v: k for k, v in KINDS.items()}
        return [None if k < 0 else
                (int(r), names[int(k)], (int(a), int(t)) if t >= 0 else int(a), float(s))
                for r, k, a, t, s in zip(self.replica, self.kind, self.key, self.token,
                                         self.sim)]


class Spans:
    """Host-clock spans of the harness's own wrappers around calls into the
    program's layers (the traced run only)."""

    def __init__(self):
        self.items: List[tuple] = []     # (label, start ns, end ns)
        self.k1: List[tuple] = []        # (queries, distinct pairs) of each fused query
        self.exec_sizes: List[int] = []  # prompts of each execution

    def wrap(self, obj, attr: str, label: str, after: Optional[Callable] = None) -> None:
        fn = getattr(obj, attr)

        def spanned(*args, **kwargs):
            t0 = time.perf_counter_ns()
            out = fn(*args, **kwargs)
            self.items.append((label, t0, time.perf_counter_ns()))
            if after is not None:
                after(args, out)
            return out
        setattr(obj, attr, spanned)


class CellRun:
    """Set-up, window and outputs of one run; ``arch`` replaces the
    configuration's program config (the CPU tests pass a reduced one)."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, *, arch=None,
                 log: Callable[[str], None] = print):
        self.cell, self.seed, self.device, self.log = cell, int(seed), torch.device(device), log
        self.m = cell.config
        self.dep = cell.deployment
        self.p = cell.params
        self.clients = int(self.p["clients"])
        self.arch = arch
        self.rounds: List[Round] = []
        self.captured: List[tuple] = []   # (task ids, (n, V) logits on the device)
        self.n_captured = 0
        self.spans: Optional[Spans] = None

    # ------------------------------------------------------------------ set-up
    def setup(self) -> None:
        t_imports = time.perf_counter()
        from repro_torch.configs import get_arch
        from repro_torch.convert import load_params
        from repro_torch.core.lsh import LSHParams
        from repro_torch.launch.serve import make_executor
        from repro_torch.models import build_model
        from repro_torch.serving import ReplicaEngine, ServingFleet

        arch = self.arch or get_arch(self.m["arch"])
        program = arch_sizes(arch)
        differ = {k: (self.m[k], program[k]) for k in SIZE_KEYS if self.m[k] != program[k]}
        if differ:
            raise ValueError(f"the program's {arch.name} differs from the configuration: {differ}")
        stages = [("start", t_imports), ("imports", time.perf_counter())]
        if self.device.type == "cuda":
            self._load_libraries()
        stages.append(("libraries", time.perf_counter()))
        dep, s = self.dep, int(self.dep["prompt_tokens"])
        tr = Traffic(self.cell.traffic, self.seed, self.clients, self.device)
        self.x = tr.rounds(int(self.p["max_rounds"]))
        self.service = self.cell.traffic["service"]
        self.pool = prompts(self.seed, PROMPT_POOL, s, self.m["vocab_size"], self.device)
        self.sample = sample_mask(self.seed, self.x.shape[0] * self.clients,
                                  float(self.p["capture_share"]))
        self.lsh = LSHParams(**dep["lsh"])
        stages.append(("traffic", time.perf_counter()))

        self.model = build_model(arch, self.device)
        load_params(self.model, Weights(self.m, self.seed, self.device))
        self._wrap_prefill()
        execute = make_executor(self.model, s)

        def execute_fn(reqs):
            self._exec_ids = [r.request_id for r in reqs]
            return list(zip(self._exec_ids, execute(reqs)))

        self.replicas = [ReplicaEngine(i, self.lsh, execute_fn,
                                       cs_capacity=dep["cs_capacity"],
                                       store_capacity=dep["store_capacity"], device=self.device)
                         for i in range(dep["replicas"])]
        self.fleet = ServingFleet(self.lsh, self.replicas, device=self.device)
        self._keep_buckets()
        self._sync()
        stages.append(("model", time.perf_counter()))
        self._fill(tr)
        self._sync()
        stages.append(("fill", time.perf_counter()))
        for r in range(int(self.p["warm_rounds"])):
            self._round(r, warm=True)
        self._sync()
        gc.collect()    # set-up's garbage is not the window's
        stages.append(("warm rounds", time.perf_counter()))
        self.log("set-up stages (s): " + ", ".join(
            f"{name} {t1 - t0:.3f}" for (_, t0), (name, t1) in zip(stages, stages[1:])))

    def _load_libraries(self) -> None:
        """Each serving kernel's library: built into ``build/kernels/`` on a
        checkout's first run, loaded from there after."""
        from repro_torch.kernels import build
        with concurrent.futures.ThreadPoolExecutor(len(SERVING_LIBS)) as pool:
            for f in [pool.submit(build.load, name) for name in SERVING_LIBS]:
                f.result()

    def _fill(self, tr: Traffic) -> None:
        """Each replica's store to capacity with earlier tasks of the mix,
        routed by the router, results made here (the fill key of the row)."""
        cap, r = int(self.dep["store_capacity"]), int(self.dep["replicas"])
        n = int(FILL_FACTOR * cap * r)
        while True:
            rows = tr.history(n)
            owners, buckets = self.fleet.router.route_batch(rows)
            if all((owners == i).sum() >= cap for i in range(r)) or n > 64 * cap * r:
                break
            n *= 2
        taken = [np.nonzero(owners == i)[0][:cap] for i in range(r)]
        for i, idx in enumerate(taken):
            if idx.size < cap:
                raise RuntimeError(f"the history fills replica {i} to {idx.size} of {cap}")
        last = max(int(idx[-1]) for idx in taken)
        self.fill_rows, self.fill_owners = rows[:last + 1], owners[:last + 1]
        self.fill_buckets = buckets[:last + 1]
        for rep, idx in zip(self.replicas, taken):
            names = [rep.name_of(self.service, b) for b in buckets[idx]]
            rep.commit_execution(self.service, rows[idx], names, [int(k) for k in idx],
                                 0.0, 0.0, buckets=buckets[idx])

    def _keep_buckets(self) -> None:
        """Keep the buckets the router and each replica compute (answers the
        check holds to the hash, then follows)."""
        route_batch = self.fleet.router.route_batch

        def kept_route(embeddings):
            out = route_batch(embeddings)
            self._route = out[1]
            return out
        self.fleet.router.route_batch = kept_route
        for rep in self.replicas:
            def kept_names(reqs, embed_batch=rep.embed_batch):
                out = embed_batch(reqs)
                self._named.append(([r.request_id for r in reqs], out[2]))
                return out
            rep.embed_batch = kept_names

    def _wrap_prefill(self) -> None:
        prefill = self.model.prefill
        want = int(self.p["check_tasks"])

        def captured_prefill(batch, max_len, *args, **kwargs):
            logits, cache = prefill(batch, max_len, *args, **kwargs)
            ids = getattr(self, "_exec_ids", [])
            rows = [k for k, t in enumerate(ids) if self.sample[t]]
            rows = rows[:max(0, want - self.n_captured)]
            if rows:
                self.captured.append(([ids[k] for k in rows],
                                      logits[rows, -1].detach().float().clone()))
                self.n_captured += len(rows)
            return logits, cache
        self.model.prefill = captured_prefill

    # ------------------------------------------------------------------ rounds
    def _requests(self, r: int) -> list:
        from repro_torch.serving import ServeRequest
        thr, c = float(self.dep["threshold"]), self.clients
        out = []
        for k in range(c):
            tid = r * c + k
            tok = torch.from_numpy(self.pool[tid % PROMPT_POOL][None, :])
            out.append(ServeRequest(tid, self.service, self.x[r, k],
                                    payload={"tokens": tok}, threshold=thr))
        return out

    def _round(self, r: int, warm: bool = False) -> Round:
        reqs = self._requests(r)
        self._named = []
        t0 = time.perf_counter()
        results = self.fleet.submit_batch_sync(reqs)
        rnd = Round.of(r, time.perf_counter() - t0, results, warm)
        rnd.route = self._route.astype(np.int16)
        rnd.names = np.full_like(rnd.route, -1)
        for ids, buckets in self._named:
            rnd.names[np.asarray(ids) - r * self.clients] = buckets
        self.rounds.append(rnd)
        return rnd

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> float:
        """Rounds until ``seconds`` have passed; -> the window's length."""
        r = len(self.rounds)
        t0 = time.perf_counter()
        while True:
            if r >= self.x.shape[0]:
                raise RuntimeError(f"the traffic ends at round {r}: max_rounds is too low")
            self._round(r)
            r += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        self.window_s = time.perf_counter() - t0
        return self.window_s

    # ------------------------------------------------------------------ tracing
    def instrument(self) -> Spans:
        """Spans around the calls into each layer; counts of each fused
        query's work and each execution's prompts."""
        sp = Spans()
        sp.wrap(self.fleet.router, "route_batch", "route")
        for rep in self.replicas:
            store = rep.stores[self.service]

            def k1(args, out, store=store):
                if store.last_query_fused:
                    n = len(args[1])
                    sp.k1.append((n, int(sum(store.candidate_counts[-n:]))))
            sp.wrap(rep, "embed_batch", "query")
            sp.wrap(rep, "query_reuse", "query", after=k1)
            sp.wrap(rep, "execute_batch", "exec",
                    after=lambda args, out: sp.exec_sizes.append(len(args[0])))
            sp.wrap(rep, "commit_execution", "insert")
        self.spans = sp
        return sp

    # ------------------------------------------------------------------ outputs
    def window_rounds(self) -> List[Round]:
        return [r for r in self.rounds if not r.warm]

    def release(self) -> Dict[str, Any]:
        """Take the outputs the check needs to the host and free the
        program's state (the model, the stores, the fleet)."""
        out = {"captured": [(ids, lg.cpu()) for ids, lg in self.captured]}
        for name in ("captured", "model", "fleet", "replicas"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return out


def latencies_ms(rounds: List[Round], clients: int) -> np.ndarray:
    """Every task's completion time: its round's, from submission to the
    return that delivers it."""
    return np.repeat([r.seconds * 1e3 for r in rounds], clients)


def percentile(values: np.ndarray, q: float) -> float:
    return float(np.percentile(values, q, method="linear"))

