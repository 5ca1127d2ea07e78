"""Continuous-batching rollout engine: sequence-level admission, in-flight
slot pool, and group-complete harvesting (the port of the JAX package's
``rl/engine.py``).

A ``waiting`` queue of prompt rows feeds a running pool of per-row decode
slots driven by ``rollout_rows_chunk`` (each row at its own cursor); rows
are harvested the moment they hit EOS or their budget (at chunk
granularity), and new prompts are admitted into freed slots mid-decode by
a B = 1 prefill into the running cache (``admit_row`` for the dense ring,
``admit_row_paged`` for the paged arena, which maps radix-cached prompt
pages and prefills only the suffix).

Group bookkeeping is the RL-specific half: RLOO/AIPO advantages are a
function of a prompt's ``n_per_prompt`` sibling completions, so the
``GroupLedger`` accumulates siblings and computes rewards and group-local
advantages when the *group* completes.  Emitted trainer batches are
assembled from the completed groups of one enqueued batch index -- batch
``n`` holds exactly the rows enqueued as batch ``n`` -- which is what makes
the per-row bounded-staleness contract ``0 <= version_floor -
row_version <= bound`` hold by construction; it is still asserted row by
row at emission.

Rows decode under the executor's current params (the admission-time
version is the conservative staleness label), and the recorded behaviour
log-prob mu is exact per token, which is the off-policy correction AIPO's
importance ratio needs.

The engine lives inside the ``GeneratorExecutor``.  The pool state stays
on the executor's device; the host reads it once a round (``done``) and
once a harvest (the harvested rows' tokens and log-probs).  Its trace
spans and instants are the reference's (``repro_torch.obs``): admission,
prefill into a slot, decode rounds, harvests, group completions, page
gauges.
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.offpolicy import PartialRolloutCache
from repro_torch.models.paging import PagePool, RadixCache, paged_blocks, \
    plan_admission, release_plan
from repro_torch.models.serve import SlotPool, assert_engine_cache
from repro_torch.obs import trace as obs_trace
from repro_torch.rl import data as rl_data
from repro_torch.rl import prng
from repro_torch.rl import rewards as rl_rewards
from repro_torch.rl.rollout import admit_row, admit_row_paged, release_row, \
    rollout_rows_chunk, start_rollout, start_row_pool
from repro_torch.rl.scheduler import RowJob


class GroupLedger:
    """Accumulates a prompt's ``n_per_prompt`` sibling completions and
    computes RLOO/AIPO advantages when the GROUP completes, not when a
    batch does.

    Keys are ``(batch_index, group)``.  A group is opened at enqueue,
    accumulates harvested sibling rows in any order, and completes when
    all ``n_per_prompt`` arrived; its rewards and group-local advantages
    are then computed at once (identical to the batch-level computation:
    RLOO/AIPO baselines only mix samples of one prompt).
    ``invalidate_batch`` drops a batch's groups when its rows die.

    Host-side bookkeeping driven by one thread -- no lock.  A duplicate
    sibling raises: harvest must never count a row twice.
    """

    def __init__(self, n_per_prompt: int, *, scorer: str = "numeric",
                 leave_one_out: bool = False):
        self.n_per_prompt = n_per_prompt
        self.scorer = scorer
        self.leave_one_out = leave_one_out
        self._open: Dict[tuple, dict] = {}
        self._complete: Dict[tuple, dict] = {}

    def open_group(self, batch_index: int, group: int, answer: str):
        gid = (batch_index, group)
        assert gid not in self._open and gid not in self._complete, \
            f"group {gid} already open -- duplicate enqueue"
        self._open[gid] = {"answer": answer, "rows": {}}

    def add(self, ticket: RowJob, row: Dict[str, Any]) -> bool:
        """Record a harvested sibling; True when its group just completed
        (its rewards and advantages are then on the group)."""
        gid = (ticket.batch_index, ticket.group)
        g = self._open[gid]
        assert ticket.sib not in g["rows"], \
            f"duplicate sibling {ticket.sib} harvested for group {gid}"
        g["rows"][ticket.sib] = row
        if len(g["rows"]) < self.n_per_prompt:
            return False
        del self._open[gid]
        rows = [g["rows"][s] for s in range(self.n_per_prompt)]
        texts = [rl_data.decode_ids(r["tokens"][r["prompt_len"]:])
                 for r in rows]
        rewards = rl_rewards.score_group([g["answer"]] * self.n_per_prompt,
                                         texts, self.scorer)
        g["rewards"] = rewards
        g["advantages"] = rl_rewards.group_advantages(
            rewards, self.n_per_prompt, self.leave_one_out)
        self._complete[gid] = g
        return True

    def pop_batch(self, batch_index: int, n_groups: int) -> List[dict]:
        """Remove and return a fully complete batch's groups in order."""
        return [self._complete.pop((batch_index, g))
                for g in range(n_groups)]

    def invalidate_batch(self, batch_index: int) -> int:
        """Drop every open or complete group of ``batch_index``; returns
        rows dropped."""
        dropped = 0
        for store in (self._open, self._complete):
            for gid in [g for g in store if g[0] == batch_index]:
                dropped += len(store.pop(gid)["rows"])
        return dropped

    @property
    def open_groups(self) -> int:
        return len(self._open)

    @property
    def complete_groups(self) -> int:
        return len(self._complete)


class RolloutEngine:
    """The in-flight pool: ``enqueue`` feeds prompt rows into ``waiting``;
    ``round()`` admits rows into free slots, decodes every live row one
    chunk, harvests finished rows into the ``GroupLedger`` and returns the
    trainer-shaped batches whose groups all completed.

    ``row_budgets`` injects per-row decode budgets (stragglers): enqueued
    row number ``i`` (a global counter, so the pattern cycles across
    batches) gets ``row_budgets[i % len]`` chunks instead of the uniform
    ``ceil(max_new / chunk)``.  ``round_delay_s`` sleeps once per decode
    round (injected decode latency).  ``kv_layout`` is ``"dense"`` or
    ``"paged"``; ``""`` defers to ``$REPRO_KV_LAYOUT``, then dense.
    """

    def __init__(self, executor, *, max_running_rows: int = 0,
                 row_budgets: Optional[List[int]] = None,
                 round_delay_s: float = 0.0, scorer: str = "numeric",
                 leave_one_out: bool = False, kv_layout: str = "",
                 kv_page_size: int = 0, kv_pages: int = 0):
        ex = executor
        assert ex.chunk and ex.chunk > 0, \
            "engine needs chunk scheduling: set chunk >= 1"
        self.kv_layout = (kv_layout
                          or os.environ.get("REPRO_KV_LAYOUT", "")
                          or "dense").strip().lower()
        assert self.kv_layout in ("dense", "paged"), \
            f"kv_layout={self.kv_layout!r}: expected dense|paged"
        assert_engine_cache(ex.cfg, self.kv_layout)
        self.executor = ex
        self.chunk = ex.chunk
        self.n_chunks = -(-ex.max_new // ex.chunk)
        self.prompt_len = ex.tasks.prompt_len
        self.total_len = self.prompt_len + self.n_chunks * self.chunk
        self.max_running_rows = int(max_running_rows) or \
            2 * ex.n_prompts * ex.n_per_prompt
        self.row_budgets = [int(b) for b in row_budgets] if row_budgets \
            else None
        self.round_delay_s = float(round_delay_s)
        self.kv_page_size = int(kv_page_size) or 16
        self._max_blocks = paged_blocks(self.total_len, self.kv_page_size)
        # default arena: every slot can hold a full row (no backpressure);
        # a smaller explicit kv_pages turns shortage into admission
        # backpressure, but one row must always fit or admission livelocks
        self.kv_pages = int(kv_pages) or \
            self.max_running_rows * self._max_blocks
        if self.kv_layout == "paged":
            assert self.kv_pages >= self._max_blocks, \
                f"kv_pages={self.kv_pages} cannot hold one row " \
                f"({self._max_blocks} blocks of {self.kv_page_size})"
            self.page_pool: Optional[PagePool] = PagePool(self.kv_pages)
            self.radix = RadixCache(self.page_pool, self.kv_page_size)
            self._row_pages: Dict[int, Any] = {}   # slot -> PagePlan
        else:
            self.page_pool = None
        self.ledger = GroupLedger(ex.n_per_prompt, scorer=scorer,
                                  leave_one_out=leave_one_out)
        self.waiting: deque = deque()
        self.slots = SlotPool(self.max_running_rows)
        self.tickets: Dict[int, RowJob] = {}      # slot -> live row ticket
        self.cache = PartialRolloutCache()        # parks pool state per round
        self._rid: Optional[int] = None
        self._batches: Dict[int, dict] = {}       # per-batch bookkeeping
        self._row_seq = 0                         # cycles row_budgets
        self._busy_s = 0.0
        self._busy_charged = 0.0
        self.stats: Dict[str, int] = {
            "rows_enqueued": 0, "rows_admitted": 0, "rows_harvested": 0,
            "batches_emitted": 0, "staleness_violations": 0,
            "admission_backpressure": 0, "radix_hits": 0,
            "radix_misses": 0, "prefix_tokens_reused": 0,
        }

    # ----------------------------------------------------------- admission --

    def enqueue(self, batch_index: int, bound: int = 0) -> int:
        """Queue one batch's worth of prompt rows (the caller has already
        gated ``committed version >= batch_index - bound``).  Returns rows
        queued."""
        ex = self.executor
        assert ex.params is not None, "weights never synchronized"
        assert batch_index not in self._batches, \
            f"batch {batch_index} already in flight"
        batch = ex.tasks.sample(ex.n_prompts, ex.n_per_prompt)
        now = time.monotonic()
        n_rows = ex.n_prompts * ex.n_per_prompt
        for r in range(n_rows):
            g, s = divmod(r, ex.n_per_prompt)
            self.waiting.append(RowJob(
                batch_index=batch_index, group=g, sib=s,
                prompt=np.asarray(batch.prompts[r]),
                answer=batch.answers[r], bound=bound,
                max_chunks=self.row_budgets[self._row_seq
                                            % len(self.row_budgets)]
                if self.row_budgets else self.n_chunks,
                enqueue_t=now))
            self._row_seq += 1
        for g in range(ex.n_prompts):
            self.ledger.open_group(batch_index, g,
                                   batch.answers[g * ex.n_per_prompt])
        self._batches[batch_index] = {
            "bound": bound, "groups_done": 0, "enqueue_t": now,
            "first_harvest_t": None,
        }
        self.stats["rows_enqueued"] += n_rows
        obs_trace.instant("enqueue", "engine", batch=batch_index,
                          rows=n_rows, bound=bound)
        return n_rows

    def _admit(self, state):
        """Fill free slots from the waiting queue: one B = 1 prefill per
        admitted row, grafted into its slot.  Each ticket pins the
        committed weight version at this moment -- the row's staleness
        label.

        Paged layout: admission first plans the row's pages --
        radix-matched prefix pages are mapped (and only the suffix
        prefilled), fresh pages allocated for the rest; a dry arena is
        clean backpressure (the ticket requeues, retried after harvests
        free pages).  The row's full-block prompt KVs are published to the
        radix tree right after the prefill, so siblings and re-admitted
        rows hit them."""
        ex = self.executor
        while self.waiting and self.slots.free_count:
            ticket = self.waiting.popleft()
            prompt = torch.as_tensor(ticket.prompt, dtype=torch.int32,
                                     device=ex.device)[None]
            if self.page_pool is not None:
                ids = tuple(int(t) for t in ticket.prompt)
                plan = plan_admission(self.page_pool, self.radix, ids,
                                      self._max_blocks, self.kv_page_size)
                if plan is None:
                    self.waiting.appendleft(ticket)
                    self.stats["admission_backpressure"] += 1
                    obs_trace.instant(
                        "admission-backpressure", "engine",
                        waiting=len(self.waiting),
                        pages_in_use=self.page_pool.pages_in_use)
                    break
                slot = self.slots.acquire()
                if plan.n_cached:
                    self.stats["radix_hits"] += 1
                    self.stats["prefix_tokens_reused"] += plan.n_cached
                    obs_trace.instant(
                        "prefix-reuse", "engine", batch=ticket.batch_index,
                        group=ticket.group, sib=ticket.sib, slot=slot,
                        cached_tokens=plan.n_cached,
                        prompt_tokens=len(ids))
                else:
                    self.stats["radix_misses"] += 1
                pages_row = torch.tensor(
                    plan.table + (self.page_pool.trash_page,),
                    dtype=torch.int32, device=ex.device)
                with obs_trace.span("prefill-into-slot", "engine",
                                    batch=ticket.batch_index,
                                    group=ticket.group, sib=ticket.sib,
                                    slot=slot, cached=plan.n_cached):
                    state = admit_row_paged(ex.params, ex.cfg, state,
                                            prompt, pages_row, slot,
                                            n_cached=plan.n_cached)
                self.radix.insert(ids, plan.table)
                self._row_pages[slot] = plan
            else:
                slot = self.slots.acquire()
                with obs_trace.span("prefill-into-slot", "engine",
                                    batch=ticket.batch_index,
                                    group=ticket.group, sib=ticket.sib,
                                    slot=slot):
                    row = start_rollout(ex.params, ex.cfg, prompt,
                                        self.total_len,
                                        cache_len=self.total_len + 1)
                    state = admit_row(state, row, slot)
            ticket.slot = slot
            ticket.weight_version = ex.weight_version
            ticket.admit_t = time.monotonic()
            self.tickets[slot] = ticket
            self.stats["rows_admitted"] += 1
        return state

    # -------------------------------------------------------- decode rounds --

    def round(self) -> List[dict]:
        """One engine tick: admit into free slots, decode every live row
        one chunk, harvest finished rows, return completed batches (each
        ``{"out": completions, "batch_index", "weight_version", "bound",
        "busy_s"}``)."""
        ex = self.executor
        t0 = time.monotonic()
        state = self.cache.get(self._rid) if self._rid is not None \
            else start_row_pool(ex.cfg, self.max_running_rows,
                                self.total_len, self.prompt_len,
                                device=ex.device, kv_layout=self.kv_layout,
                                kv_page_size=self.kv_page_size,
                                kv_pages=self.kv_pages)
        self._rid = None
        with obs_trace.span("admit", "engine", waiting=len(self.waiting),
                            free=self.slots.free_count):
            state = self._admit(state)
        emitted: List[dict] = []
        if self.tickets:
            if self.round_delay_s:
                time.sleep(self.round_delay_s)   # injected decode latency
            with obs_trace.span("decode-round", "engine",
                                rows=len(self.tickets)):
                ex.key, sub = prng.split(ex.key)
                state = rollout_rows_chunk(ex.params, ex.cfg, state, sub,
                                           n_steps=self.chunk,
                                           temperature=ex.temperature)
            for t in self.tickets.values():
                t.chunks_done += 1
            state, emitted = self._harvest(state)
        if self.page_pool is not None:
            obs_trace.instant("pages", "engine",
                              pages_in_use=self.page_pool.pages_in_use,
                              pages_total=self.page_pool.n_pages,
                              radix_nodes=len(self.radix))
        self._rid = self.cache.put(state)
        self._busy_s += time.monotonic() - t0
        return emitted

    def _harvest(self, state):
        """Free every finished row (EOS, or its budget spent) into the
        ledger; assemble the batches whose groups all completed.  Returns
        ``(state, emitted)``; a paged harvest also releases the row's page
        refs and remaps its table to the trash page."""
        ex = self.executor
        done = state.done.cpu().numpy()
        ready = [s for s, t in self.tickets.items()
                 if done[s] or t.chunks_done >= t.max_chunks]
        if not ready:
            return state, []
        emitted = []
        keep = self.prompt_len + ex.max_new
        with obs_trace.span("harvest", "engine", rows=len(ready)):
            tokens_np = state.tokens.cpu().numpy()
            blp_np = state.behavior_logp.cpu().numpy()
            for s in ready:
                t = self.tickets.pop(s)
                self.slots.release(s)
                if self.page_pool is not None:
                    release_plan(self.page_pool, self._row_pages.pop(s))
                    state = release_row(state, s)
                row = {
                    "tokens": tokens_np[s, :keep].copy(),
                    "logp": blp_np[s, :keep].copy(),
                    "version": t.weight_version,
                    "prompt_len": self.prompt_len,
                    "queue_wait_s": t.admit_t - t.enqueue_t,
                }
                self.stats["rows_harvested"] += 1
                obs_trace.instant("harvest-row", "engine",
                                  batch=t.batch_index, group=t.group,
                                  sib=t.sib, slot=s,
                                  queue_wait_s=row["queue_wait_s"])
                bk = self._batches[t.batch_index]
                if bk["first_harvest_t"] is None:
                    bk["first_harvest_t"] = time.monotonic()
                    obs_trace.instant(
                        "first-harvest", "engine", batch=t.batch_index,
                        ttfh_s=bk["first_harvest_t"] - bk["enqueue_t"])
                if self.ledger.add(t, row):
                    bk["groups_done"] += 1
                    obs_trace.instant("group-complete", "engine",
                                      batch=t.batch_index, group=t.group)
                    if bk["groups_done"] == ex.n_prompts:
                        emitted.append(self._emit(t.batch_index))
        return state, emitted

    def _emit(self, batch_index: int) -> dict:
        """Assemble the trainer-shaped batch from a batch index's completed
        groups, asserting the per-row staleness contract.  ``tokens``,
        ``behavior_logp`` and ``mask`` are tensors on the executor's
        device, as ``GeneratorExecutor.emit_batch`` gives them; the
        per-row labels and group scores are numpy arrays."""
        ex = self.executor
        bk = self._batches.pop(batch_index)
        groups = self.ledger.pop_batch(batch_index, ex.n_prompts)
        rows = [g["rows"][s] for g in groups
                for s in range(ex.n_per_prompt)]
        tokens = np.stack([r["tokens"] for r in rows])
        blp = np.stack([r["logp"] for r in rows]).astype(np.float32)
        versions = np.asarray([r["version"] for r in rows], np.int64)
        floor = int(versions.max())
        # the batch's version floor may not run ahead of any row by more
        # than the bound in effect at enqueue (and never behind)
        lag = floor - versions
        bad = (lag < 0) | (lag > bk["bound"])
        if bad.any():
            self.stats["staleness_violations"] += int(bad.sum())
            raise AssertionError(
                f"per-row staleness contract violated for batch "
                f"{batch_index}: floor={floor} bound={bk['bound']} "
                f"row versions={versions.tolist()}")
        Sp = self.prompt_len
        ar = np.arange(tokens.shape[1])[None, :]
        mask = ((ar >= Sp) & (tokens != rl_data.PAD)).astype(np.float32)
        out = {
            "tokens": torch.as_tensor(tokens, device=ex.device),
            "behavior_logp": torch.as_tensor(blp, device=ex.device),
            "mask": torch.as_tensor(mask, device=ex.device),
            "prompt_len": Sp,
            "answers": [g["answer"] for g in groups
                        for _ in range(ex.n_per_prompt)],
            # min over rows: the conservative batch-level label the
            # controller's staleness check consumes
            "weight_version": int(versions.min()),
            "row_versions": versions,
            "version_floor": floor,
            "group_rewards": np.concatenate([g["rewards"] for g in groups]),
            "group_advantages": np.concatenate(
                [g["advantages"] for g in groups]),
        }
        busy = self._busy_s - self._busy_charged
        self._busy_charged = self._busy_s
        self.stats["batches_emitted"] += 1
        obs_trace.instant("emit", "engine", batch=batch_index,
                          version=out["weight_version"], floor=floor)
        return {"out": out, "batch_index": batch_index,
                "weight_version": out["weight_version"],
                "bound": bk["bound"], "busy_s": busy}

    # ------------------------------------------------------------- teardown --

    def inflight_batches(self) -> List[int]:
        """Enqueued-but-unemitted batch indices."""
        return sorted(self._batches)

    def abort(self) -> int:
        """Drop all in-flight work -- waiting rows, live tickets, parked
        pool state, ledger groups.  Returns rows dropped.  Leak-free: the
        parked state leaves the ``PartialRolloutCache``, every slot is
        freed, and in the paged layout every page returns to the pool."""
        dropped = len(self.waiting) + len(self.tickets)
        if self._rid is not None:
            self.cache.get(self._rid)            # evict the parked state
            self._rid = None
        self.waiting.clear()
        for s in list(self.tickets):
            self.tickets.pop(s)
            self.slots.release(s)
            if self.page_pool is not None:
                release_plan(self.page_pool, self._row_pages.pop(s))
        for b in list(self._batches):
            self.ledger.invalidate_batch(b)
            del self._batches[b]
        if self.page_pool is not None:
            # radix residency is the last class of page refs; after
            # dropping it the arena must be fully free or pages leaked
            self.radix.clear()
            self.page_pool.assert_no_leaks()
        return dropped

    def snapshot_stats(self) -> Dict[str, Any]:
        """Engine counters, with the live occupancy."""
        out = {**self.stats, "waiting": len(self.waiting),
               "running": len(self.tickets),
               "max_running_rows": self.max_running_rows,
               "open_groups": self.ledger.open_groups,
               "busy_s": self._busy_s, "kv_layout": self.kv_layout}
        if self.page_pool is not None:
            lookups = self.stats["radix_hits"] + self.stats["radix_misses"]
            out.update(
                pages_in_use=self.page_pool.pages_in_use,
                pages_total=self.page_pool.n_pages,
                radix_nodes=len(self.radix),
                radix_hit_rate=self.stats["radix_hits"] / lookups
                if lookups else 0.0)
        return out
