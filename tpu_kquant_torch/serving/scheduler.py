"""Continuous batching: the port of ``tpu_kquant.serving.scheduler``.

A fixed pool of B batch slots over one shared KV cache. Each tick:
  1. queued requests are admitted into free slots: one request through the
     engine's slot prefill (a forward over a view of its cache row), two or
     more as one burst. Their last-position logits stay on the device as the
     rows' pending logits;
  2. one decode step for every slot, then the sampler chain. Freshly
     admitted rows sample from their pending logits instead of the decode
     output; their decode this tick is a dummy whose K/V write at their
     position is overwritten by the real decode there next tick, the same
     argument that makes padded prefill safe (runtime.engine). Inactive
     slots idle at position 0 likewise. Sampling uses per-row settings and
     per-request randomness keyed by (seed, step): a request's tokens do not
     depend on its slot or on the batch around it;
  3. the [B] sampled ints come to the host (the tick's only sync); tokens
     are emitted and finished requests retired.

Every per-slot field (next tokens, positions, sampler settings, seeds and
step counts, penalty rings, pending logits, active and fresh masks) lives in
device tensors (``_DevState``) that the tick updates in place, so a
steady-state tick copies nothing from the host to the device. Admission
writes each field's rows with one indexed write; retirement clears each
field with one masked write.

Between admissions, ``run`` takes chunks of up to MAX_CHUNK ticks
(``step_chunk``): rows whose sampled token is their eos freeze on the device
(the reference's ``_tick_n_fn``), and the sampled tokens come back once per
chunk. Token streams equal per-tick stepping.

On a CUDA device the tick is a replay of one captured step (runtime.graphs;
one graph for greedy ticks, one for sampled, on the batcher's cache and
``_DevState``): the tick, then on the device the eos freeze, its tokens into
the next row of the chunk's record ([MAX_CHUNK, B] tokens, then the next
row and the count of ticks that began with a live row) and a running "all
logits finite" flag (``logits_finite``). A chunk of n ticks is n replays and
one host read of the record; the admission tick (``step``) is one replay
and one read of its [B] tokens. Where the reference's device loop stops once
no row is live, the replayed chunk runs its n ticks, the last ones on an
all-inactive batch; such a tick changes nothing the host reads later: no
row's token or position moves (both follow ``active``), a recurrent row's
state does not (``valid`` = active and not fresh), no row is fresh, and the
penalty rings and ``steps`` it does move belong to rows whose requests are
done, which retirement parks and the next admission writes over; its tokens
lie past ``count``, which the host reads. ``stats["ticks_run"]`` counts the
ticks the device ran, these included (``chunk_ticks`` those of chunks, in
``chunks`` chunks). On the CPU, or with ``plain=True``,
the tick is the plain eager one and the chunk the plain loop, which ends
once no row is active (one 4-byte read per tick); ``plain=False`` on the CPU
runs the captured step's body eagerly.

The admission burst prefills the k waiting requests as one [k, T] forward
over a temporary cache of T slots (T the prompts' bucket; the reference
pads the burst to B rows and takes a second full cache, which at 1024 slots
of 2048 would not fit beside the first) and copies each row's T slots into
its batch row with one indexed write per cache tensor. Slots past T keep
what they held: they lie past each row's position, so they are masked
until a decode step writes them.

On a recurrent model (mamba) a dummy decode would not be overwritten: a
state update is forever. So a tick's decode step takes ``valid`` = active
and not fresh, and the fresh and idle rows keep their pre-tick state, bit
for bit (the reference restores them after the step, scheduler.py:162-185);
a reused slot's prefill starts from zeros (engine._prefill_slot), and the
burst prefills into a fresh state whose rows are copied into their slots.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from tpu_kquant_torch.ops.sampling import (
    apply_penalties_rows,
    greedy,
    sample_rows,
    update_penalty_state_rows,
)
from tpu_kquant_torch.runtime.engine import InferenceEngine, _bucket
from tpu_kquant_torch.runtime.graphs import GraphCache, StepGraph, switches
from tpu_kquant_torch.runtime.kv_cache import set_batch_rows


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    repeat_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    penalty_last_n: int = 64
    eos_id: int | None = None
    seed: int | None = None  # per-request randomness; None -> scheduler seed + 7919 rid
    # filled by the scheduler
    rid: int = -1
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _Slot:
    req: Request | None = None
    pos: int = 0  # next decode position (host shadow for retirement checks)


@dataclasses.dataclass
class _DevState:
    """Per-slot serving state on the device, updated in place."""

    toks: torch.Tensor     # [B] i64 next token per slot
    poss: torch.Tensor     # [B] i64 next decode position
    fresh: torch.Tensor    # [B] bool: sample from the pending logits this tick
    active: torch.Tensor   # [B] bool
    steps: torch.Tensor    # [B] i64 tokens sampled by the slot's request (noise step)
    seeds: torch.Tensor    # [B] i64
    eos: torch.Tensor      # [B] i64 eos id, -1 for none (read by step_chunk)
    temps: torch.Tensor    # [B] f32
    top_ks: torch.Tensor   # [B] i64
    top_ps: torch.Tensor   # [B] f32
    min_ps: torch.Tensor   # [B] f32
    rps: torch.Tensor      # [B] f32
    pps: torch.Tensor      # [B] f32
    fps: torch.Tensor      # [B] f32
    last_ns: torch.Tensor  # [B] i32
    pending: torch.Tensor  # [B, V] f32 pending prefill logits
    counts: torch.Tensor   # [B, V] i32 penalty counts
    window: torch.Tensor   # [B, W] i32 penalty token ring
    widx: torch.Tensor     # [B] i32
    nfill: torch.Tensor    # [B] i32

    @staticmethod
    def create(B: int, V: int, W: int, device) -> "_DevState":
        def z(*shape, dtype=torch.int64, fill=0):
            return torch.full(shape, fill, dtype=dtype, device=device)

        f32, i32 = torch.float32, torch.int32
        return _DevState(
            toks=z(B), poss=z(B), fresh=z(B, dtype=torch.bool), active=z(B, dtype=torch.bool),
            steps=z(B), seeds=z(B), eos=z(B, fill=-1), temps=z(B, dtype=f32), top_ks=z(B),
            top_ps=z(B, dtype=f32, fill=1.0), min_ps=z(B, dtype=f32),
            rps=z(B, dtype=f32, fill=1.0), pps=z(B, dtype=f32), fps=z(B, dtype=f32),
            last_ns=z(B, dtype=i32), pending=z(B, V, dtype=f32), counts=z(B, V, dtype=i32),
            window=z(B, W, dtype=i32), widx=z(B, dtype=i32), nfill=z(B, dtype=i32))

    def put_rows(self, idx: torch.Tensor, **rows) -> None:
        """field[idx] = value for each field given (host arrays or device
        tensors of the fields' trailing shape): one indexed write each."""
        for name, value in rows.items():
            dst = getattr(self, name)
            dst[idx] = torch.as_tensor(value, dtype=dst.dtype).to(dst.device, non_blocking=True)

    # retirement: the values a parked slot holds (sampler off, position 0)
    PARKED = {"active": False, "temps": 0.0, "rps": 1.0, "pps": 0.0, "fps": 0.0,
              "last_ns": 0, "poss": 0, "toks": 0}


class ContinuousBatcher:
    PENALTY_WINDOW_CAP = 128  # ring size; per-row last_n <= cap
    MAX_CHUNK = 32  # ticks per chunk at most

    def __init__(self, engine: InferenceEngine, seed: int = 0, mesh=None,
                 plain: bool | None = None):
        """plain: the eager tick and chunk loop (default: on the CPU only;
        module docstring)."""
        if mesh is not None:
            raise NotImplementedError("serving over a device mesh waits for parallel/")
        self.engine = engine
        self.B = B = engine.max_batch
        self.device = engine.device
        self.plain = engine.device.type != "cuda" if plain is None else plain
        self._graphs = GraphCache()
        # the chunk's record: [MAX_CHUNK, B] tokens, then (next row, count)
        self._record = torch.zeros(self.MAX_CHUNK * B + 2, dtype=torch.long,
                                   device=self.device)
        self._rows = self._record[:-2].view(self.MAX_CHUNK, B)
        self._next_row, self._count = self._record[-2:-1], self._record[-1:]
        self.logits_finite = torch.ones((), dtype=torch.bool, device=self.device)
        self.cache = engine.new_cache(B)
        self.slots = [_Slot() for _ in range(B)]
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self._rid = itertools.count()
        self._seed = seed
        self.state = _DevState.create(B, engine.cfg.vocab_size, self.PENALTY_WINDOW_CAP,
                                      self.device)
        self.tick_logits: torch.Tensor | None = None  # [B, V] the last tick sampled from
        self.stats = {
            "steps": 0, "prefills": 0, "tokens_out": 0, "tokens_in": 0,
            "wall_s": 0.0, "batch_occupancy_sum": 0, "ticks_run": 0, "chunks": 0,
            "chunk_ticks": 0,
            # tick, chunk, admission and retirement calls, counted where the
            # reference counts its device dispatches
            "dispatches": 0,
        }

    def report(self) -> dict:
        s = dict(self.stats)
        s["decode_tok_s"] = s["tokens_out"] / s["wall_s"] if s["wall_s"] else 0.0
        s["avg_batch_occupancy"] = (s["batch_occupancy_sum"] / s["steps"]
                                    if s["steps"] else 0.0)
        return s

    # -- public API ------------------------------------------------------------
    def submit(self, req: Request) -> int:
        # validated here, before any slot or queue state exists for it
        if len(req.prompt) > self.engine.max_seq:
            raise ValueError(f"prompt length {len(req.prompt)} exceeds max_seq "
                             f"{self.engine.max_seq}")
        req.rid = next(self._rid)
        req.penalty_last_n = min(req.penalty_last_n, self.PENALTY_WINDOW_CAP)
        self.queue.append(req)
        return req.rid

    @property
    def active(self) -> int:
        return sum(s.req is not None for s in self.slots)

    def has_work(self) -> bool:
        return self.active > 0 or len(self.queue) > 0

    def run(self, on_token: Callable[[Request, int], None] | None = None,
            max_chunk: int | None = None) -> list[Request]:
        """Drain all submitted requests; returns them in completion order.
        Between admissions, runs chunks of ticks (step_chunk); max_chunk
        defaults to 1 (per tick) when on_token is given, so a streaming
        consumer gets each token at its tick, and to MAX_CHUNK otherwise."""
        if max_chunk is None:
            max_chunk = 1 if on_token is not None else self.MAX_CHUNK
        while self.has_work():
            self.step(on_token)
            n = self._safe_chunk(max_chunk)
            if n >= 2:
                self.step_chunk(n, on_token)
        out, self.finished = self.finished, []
        return out

    def _sampling_live(self) -> bool:
        """True if any active request needs the sampler chain (temperature or
        penalties); all-greedy ticks take the argmax and skip its sorts."""
        return any(r.temperature > 0.0 or r.repeat_penalty != 1.0
                   or r.presence_penalty != 0.0 or r.frequency_penalty != 0.0
                   for r in (s.req for s in self.slots) if r is not None)

    def _safe_chunk(self, max_chunk: int) -> int:
        """Largest tick count that cannot overrun any slot's budget or KV
        room: a chunk ends no later than the earliest possible completion,
        so queued requests are admitted as soon as under per-tick stepping."""
        if self.active == 0:
            return 0
        lim = min(max_chunk, self.MAX_CHUNK)
        for slot in self.slots:
            req = slot.req
            if req is not None:
                lim = min(lim, req.max_new_tokens - len(req.output),
                          self.engine.max_seq - 1 - slot.pos)
        return max(lim, 0)

    # -- the tick --------------------------------------------------------------
    @torch.no_grad()
    def _tick(self, sampling: bool) -> torch.Tensor:
        """One decode step of every slot and the sampler chain, all on the
        device; returns the sampled tokens [B] (i64, on the device)."""
        st = self.state
        valid = (st.active & ~st.fresh) if self.engine.cfg.is_recurrent else None
        logits, self.cache = self.engine.decode_step(st.toks, st.poss, self.cache, valid)
        l = torch.where(st.fresh[:, None], st.pending, logits.float())
        self.tick_logits = l
        self.logits_finite.logical_and_(l.isfinite().all())
        if sampling:
            l = apply_penalties_rows(l, st.counts, st.rps, st.pps, st.fps)
            tok = sample_rows(l, torch.stack([st.seeds, st.steps], dim=1), st.temps,
                              st.top_ks, st.top_ps, st.min_ps)
            update_penalty_state_rows((st.counts, st.window, st.widx, st.nfill), tok,
                                      st.last_ns)
        else:
            tok = greedy(l)
        tok = tok.long()
        st.toks.copy_(torch.where(st.active, tok, st.toks))
        st.poss.add_((st.active & ~st.fresh).long())
        st.fresh.zero_()
        st.steps.add_(1)
        return tok

    @torch.no_grad()
    def _graph_tick(self, sampling: bool) -> tuple:
        """The captured step (module docstring): the tick, then the eos
        freeze, the tokens into the record's next row, the count of ticks
        that began with a live row. Returns (tokens [B], tick logits)."""
        st = self.state
        live = st.active.any()
        tok = self._tick(sampling)
        st.active.logical_and_(~((st.eos >= 0) & (tok == st.eos)))
        self._rows.index_copy_(0, self._next_row, tok[None])
        self._next_row.add_(1)
        self._count.add_(live.long())
        return tok, self.tick_logits

    def _replay_tick(self, sampling: bool) -> torch.Tensor:
        """One run of the captured tick (greedy or sampled); returns its
        tokens [B]."""
        graph = self._graphs.get((sampling, switches()), lambda: StepGraph(self.device))
        tok, self.tick_logits = graph.run(self._graph_tick, sampling)
        return tok

    def step_chunk(self, n: int, on_token=None) -> None:
        """Up to n ticks with no admission between them. A row whose sampled
        token is its eos goes inactive on the device (its token and position
        freeze); ``count`` ticks began with an active row. The tokens come
        to the host once, at the end (module docstring)."""
        t_start = time.perf_counter()
        occupancy = self.active
        sampling = self._sampling_live()
        st = self.state
        if self.plain:
            toks = []
            for _ in range(n):
                tok = self._tick(sampling)
                hit = st.active & (st.eos >= 0) & (tok == st.eos)
                st.active.logical_and_(~hit)
                toks.append(tok)
                if not bool(st.active.any()):  # the exit test: one 4-byte read
                    break
            sampled = torch.stack(toks).cpu().numpy()  # [count, B]
            count = len(toks)
        else:
            self._record[-2:].zero_()
            for _ in range(n):
                self._replay_tick(sampling)
            record = self._record.cpu().numpy()  # the chunk's one host read
            count = int(record[-1])
            sampled = record[:-2].reshape(self.MAX_CHUNK, self.B)
        self.stats["dispatches"] += 1
        self.stats["chunks"] += 1
        self.stats["chunk_ticks"] += count if self.plain else n
        self.stats["ticks_run"] += count if self.plain else n
        for j in range(count):
            for b, slot in enumerate(self.slots):
                req = slot.req
                if req is None or req.done:
                    continue
                slot.pos += 1
                self._emit(req, int(sampled[j, b]), on_token)
        self._retire_finished()
        self.stats["steps"] += count
        self.stats["batch_occupancy_sum"] += occupancy * count
        self.stats["wall_s"] += time.perf_counter() - t_start

    def step(self, on_token=None) -> None:
        """One tick: admissions, a decode of every slot with the sampler,
        emission and retirement."""
        t_start = time.perf_counter()
        fresh = np.zeros(self.B, bool)
        pairs = []
        for b, slot in enumerate(self.slots):
            if slot.req is None and self.queue:
                req = self.queue.popleft()
                self.stats["prefills"] += 1
                self.stats["tokens_in"] += len(req.prompt)
                slot.req = req
                slot.pos = len(req.prompt)
                pairs.append((b, req))
                fresh[b] = True
        if len(pairs) == 1:
            self._admit(*pairs[0])
        elif pairs:
            self._admit_burst(pairs)
        if self.active == 0:
            return
        if self.plain:
            tok = self._tick(self._sampling_live())
        else:
            self._record[-2:].zero_()
            tok = self._replay_tick(self._sampling_live())
        self.stats["dispatches"] += 1
        self.stats["ticks_run"] += 1
        sampled = tok.cpu().numpy()  # the tick's only host sync
        for b, slot in enumerate(self.slots):
            if slot.req is None:
                continue
            if not fresh[b]:
                slot.pos += 1  # a fresh row's first real decode is next tick
            self._emit(slot.req, int(sampled[b]), on_token)
        self._retire_finished()
        self.stats["steps"] += 1
        self.stats["batch_occupancy_sum"] += self.active
        self.stats["wall_s"] += time.perf_counter() - t_start

    # -- admission and retirement ----------------------------------------------
    def _req_args(self, req: Request) -> dict:
        """Host-side admission fields of a request (numpy; no device work):
        its seed, and its penalty window primed from the prompt's tail
        (llama.cpp's semantics)."""
        uses_pen = (req.repeat_penalty != 1.0 or req.presence_penalty != 0.0
                    or req.frequency_penalty != 0.0) and req.penalty_last_n > 0
        last_n = req.penalty_last_n if uses_pen else 0
        seed = req.seed if req.seed is not None else self._seed + 7919 * req.rid
        W = self.PENALTY_WINDOW_CAP
        window = np.zeros(W, np.int32)
        widx = nfill = 0
        tail = req.prompt[-last_n:] if last_n > 0 else []
        if tail:
            window[: len(tail)] = tail
            widx, nfill = len(tail) % last_n, len(tail)
        return dict(last_n=last_n, seed=seed, tail=tail, window=window, widx=widx,
                    nfill=nfill)

    def _admit_rows(self, slots: list[int], reqs: list[Request], row_logits: torch.Tensor):
        """Set every per-slot field of the admitted rows, one indexed write
        per field; row_logits [k, V] become their pending logits."""
        args = [self._req_args(r) for r in reqs]
        counts = np.zeros((len(reqs), self.engine.cfg.vocab_size), np.int32)
        for j, a in enumerate(args):
            np.add.at(counts[j], np.asarray(a["tail"], np.int64), 1)
        col = lambda key: [a[key] for a in args]  # noqa: E731
        field = lambda attr: [getattr(r, attr) for r in reqs]  # noqa: E731
        idx = torch.tensor(slots, dtype=torch.long).to(self.device)
        self.state.put_rows(
            idx, toks=0, poss=[len(r.prompt) for r in reqs], fresh=True, active=True, steps=0,
            seeds=col("seed"), eos=[-1 if r.eos_id is None else r.eos_id for r in reqs],
            temps=field("temperature"), top_ks=field("top_k"), top_ps=field("top_p"),
            min_ps=field("min_p"), rps=field("repeat_penalty"), pps=field("presence_penalty"),
            fps=field("frequency_penalty"), last_ns=col("last_n"), pending=row_logits.float(),
            counts=counts, window=np.stack(col("window")), widx=col("widx"),
            nfill=col("nfill"))

    def _admit(self, b: int, req: Request) -> None:
        """One request through the engine's slot prefill into row b."""
        eng = self.engine
        if eng.kv_layout != "unified":
            raise NotImplementedError("slot prefill requires the unified KV layout")
        n = len(req.prompt)
        T = min(_bucket(n), eng.max_seq)
        toks = np.zeros((1, T), np.int64)
        toks[0, :n] = req.prompt
        positions = np.arange(T)[None, :]
        valid = torch.from_numpy(positions < n).to(self.device)
        self.stats["dispatches"] += 1
        logits, self.cache = eng._prefill_slot(eng._tensor(toks), eng._tensor(positions),
                                               self.cache, b, valid)
        self._admit_rows([b], [req], logits[n - 1][None])

    def _admit_burst(self, pairs: list) -> None:
        """k >= 2 admissions as one [k, T] prefill over a temporary cache of
        T slots (module docstring), its rows copied into their slots."""
        eng = self.engine
        if eng.kv_layout != "unified":
            raise NotImplementedError("slot prefill requires the unified KV layout")
        slots, reqs = [b for b, _r in pairs], [r for _b, r in pairs]
        k = len(pairs)
        lens = np.array([len(r.prompt) for r in reqs], np.int64)
        T = min(_bucket(int(lens.max())), eng.max_seq)
        toks = np.zeros((k, T), np.int64)
        for j, r in enumerate(reqs):
            toks[j, : lens[j]] = r.prompt
        positions = np.broadcast_to(np.arange(T), (k, T))
        valid = torch.from_numpy(positions < lens[:, None]).to(self.device)
        self.stats["dispatches"] += 1
        tmp = eng.new_cache(k, max_seq=T)
        logits, tmp = eng._step_valid(eng._tensor(toks), eng._tensor(positions), tmp, valid)
        idx = torch.tensor(slots, dtype=torch.long).to(self.device)
        if eng.cfg.is_recurrent:
            self.cache.set_rows(tmp, idx)
        else:
            set_batch_rows(self.cache, tmp, idx)
        del tmp
        last = logits[torch.arange(k, device=self.device), eng._tensor(lens - 1)]
        del logits
        self._admit_rows(slots, reqs, last)

    def _emit(self, req: Request, tok: int, on_token) -> None:
        self.stats["tokens_out"] += 1
        req.output.append(tok)
        if on_token:
            on_token(req, tok)
        if (req.eos_id is not None and tok == req.eos_id) or \
                len(req.output) >= req.max_new_tokens:
            req.done = True

    def _retire_finished(self) -> None:
        """Free the slots whose request is done or whose cache row is full,
        and park their device rows (one masked write per field)."""
        bs = []
        for b, slot in enumerate(self.slots):
            if slot.req is not None and (slot.req.done
                                         or slot.pos + 1 >= self.engine.max_seq):
                slot.req.done = True
                bs.append(b)
        if not bs:
            return
        mask = np.zeros(self.B, bool)
        for b in bs:
            req = self.slots[b].req
            self.slots[b] = _Slot()
            mask[b] = True
            if req is not None:
                self.finished.append(req)
        self.stats["dispatches"] += 1
        m = torch.from_numpy(mask).to(self.device)
        for name, value in _DevState.PARKED.items():
            getattr(self.state, name).masked_fill_(m, value)
