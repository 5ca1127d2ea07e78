"""Executors (paper Sec. 5.1.1): generator, reward, frozen reference and
trainer (the port of the JAX package's ``core/executor.py``).

Each executor exposes the reference's port surface -- ``put_input`` /
``step`` / ``get_output`` -- so a controller wires them as it wires the
JAX ones.  The generator also carries the chunk-stepping hooks the pool's
``RolloutScheduler`` drives (with their pinned-params forms) and the
continuous-batching engine's hooks (``engine_*``).

``mesh=`` is the executor's own ``DeviceMesh`` (``DeviceSpec.mesh_shape``
builds it where the actor lives).  Every rank of the mesh holds the
executor and runs each endpoint call.  The trainer keeps its state in
shards (``train/sharded.shard_state``) and steps with
``make_sharded_train_step``; it publishes its params whole.  A
generator of the dense or MoE family on a mesh whose ``model`` axis has
more than one rank serves tensor-parallel (``models/tp.py``): each rank
holds its shard (``sharding.tp_plan``, carried by ``ddma_weight_sync``
onto ``sharding.Shardings``) and computes its heads, FFN columns or
experts and vocabulary slice, on its share of the rows where the data
axes split them (the sampler keys the noise by the global row and
column, so a rank draws its rows alone), and every rank emits the whole
batch.  The mesh decides, as the params' placement decides in the
reference; the engine hooks refuse such a generator (the paged engine
on a mesh is not ported).  A dense or MoE reference on such a mesh
holds the same TP shard and scores its share of the rows with
``models.tp.forward_train`` and the vocabulary-parallel log-prob, then
gathers the rows.  Every other
generator and reference hold the weights replicated, each rank the
whole tree, and compute the whole batch on every rank.  A dense or MoE
trainer on such a mesh steps tensor-parallel (``train/sharded.py``).  An
executor with a mesh takes each payload whole: a DTensor that
``InprocTransport.prepare`` placed on the mesh becomes its local tensor
where replicated and is gathered where split (the sharded train step
keeps its own rows of the global batch).
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import ddma
from repro_torch.core.aipo import token_logprobs
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import forward_train
from repro_torch.models import tp as tpmod
from repro_torch.models.sharding import Shardings, tp_plan
from repro_torch.rl import data as rl_data
from repro_torch.rl import prng
from repro_torch.rl import rewards as rl_rewards
from repro_torch.rl.engine import RolloutEngine
from repro_torch.rl.rollout import action_mask, finalize_rollout, \
    rollout_chunk, start_rollout
from repro_torch.rl.scheduler import RolloutJob
from repro_torch.train.trainstep import TrainState, init_train_state, \
    make_train_step


class PinnedParams:
    """Marker standing in for ``RolloutJob.params`` when the admission-
    time weight snapshot is *pinned* inside the generator
    (``begin_batch_pinned``): the job carries a small reference instead of
    the params; ``emit_batch`` releases the pin."""

    __slots__ = ("key",)

    def __init__(self, key: int):
        self.key = key


class Executor:
    """Base executor: lock-guarded input/output ports and a step counter."""

    role = "generic"

    def __init__(self, name: str, mesh=None):
        self.name = name
        self.mesh = mesh
        self.curr_step = 0
        self._port_lock = threading.RLock()
        self._outputs: Dict[str, Any] = {}
        self._inputs: Dict[str, Any] = {}
        self._staged_weights: Dict[int, Any] = {}

    def init(self):
        pass

    def set_step(self, i: int):
        self.curr_step = i

    def step(self):
        raise NotImplementedError

    def get_output(self, name: str):
        with self._port_lock:
            return self._outputs[name]

    def set_output(self, name: str, value):
        with self._port_lock:
            self._outputs[name] = value

    def put_input(self, name: str, value):
        if self.mesh is not None:
            value = ddma.whole(value)
        with self._port_lock:
            self._inputs[name] = value

    def get_input(self, name: str, default=None):
        with self._port_lock:
            return self._inputs.get(name, default)

    def ping(self) -> str:
        """Health endpoint: a live actor answers with its name."""
        return self.name

    def chaos_hang(self, seconds: float):
        """Fault-injection endpoint (``FaultPlan`` "hang"): wedge this
        actor's server loop so the caller's timeout fires and the
        supervisor's hang-or-slow triage runs."""
        time.sleep(float(seconds))

    def save_checkpoint(self, path: str, step: int):
        """Periodic checkpoint hook (``checkpoint_every``); only the
        trainer has state worth saving."""

    # ------------------------------------------- weight-fabric slot surface --
    # ``stage_weights`` parks a versioned snapshot without applying it; the
    # ``commit_weights`` call later switches the executor to it at a
    # staleness-legal boundary.

    def stage_weights(self, params, version: int):
        """Park a published snapshot.  Slots are refcounted: several
        channels staging one version commit it once each."""
        with self._port_lock:
            cur = self._staged_weights.get(version)
            self._staged_weights[version] = \
                (params, 1 if cur is None else cur[1] + 1)

    def commit_weights(self, version: int):
        """Apply a staged snapshot; release its slot once every stager's
        commit arrived."""
        with self._port_lock:
            params, n = self._staged_weights[version]
            if n <= 1:
                self._staged_weights.pop(version)
            else:
                self._staged_weights[version] = (params, n - 1)
        self.set_weights(params, version=version)

    def staged_versions(self) -> List[int]:
        """Versions staged but not yet committed."""
        with self._port_lock:
            return sorted(self._staged_weights)

    def configure(self, **attrs):
        """Set existing executor attributes by name."""
        for k, v in attrs.items():
            if not hasattr(self, k):
                raise AttributeError(
                    f"executor '{self.name}' has no attribute {k!r}")
            setattr(self, k, v)

    def step_snapshot(self, names):
        """``step()`` and an output-port snapshot in one endpoint (what
        the pool's complete-batch worker pushes)."""
        self.step()
        return {n: self.get_output(n) for n in names}


class GeneratorExecutor(Executor):
    """Policy inference: rollouts + behaviour log-probs (+ optional int8
    fake-quantized weights).

    ``begin_batch`` / ``advance_chunk`` / ``emit_batch`` are the resumable
    hooks; ``step()`` runs them back to back.  Keys follow the reference's
    discipline: one split of the executor key per batch, one split of the
    batch key per chunk, one split of the chunk key per step.
    """

    role = "generator"

    def __init__(self, cfg, tasks: rl_data.ArithmeticTasks, *,
                 n_prompts: int, n_per_prompt: int, max_new: int,
                 temperature: float = 1.0, quantize: bool = False,
                 chunk: int = 0, seed: int = 0, device: DeviceLike = None,
                 name: str = "generator", mesh=None):
        super().__init__(name, mesh)
        self.cfg = cfg
        self.tasks = tasks
        self.n_prompts = n_prompts
        self.n_per_prompt = n_per_prompt
        self.max_new = max_new
        self.temperature = temperature
        self.quantize = quantize
        self.chunk = chunk
        self.device = resolve(device)
        self.key = prng.PRNGKey(seed)
        self.params = None
        self.weight_version = -1        # version of self.params (-1 = unset)
        self._pinned: Dict[int, Any] = {}    # admission snapshots by pin key
        self._pin_seq = 0
        self._engine = None             # lazy RolloutEngine (engine mode)
        # this rank of a tensor-parallel mesh (None: the whole tree)
        self.tp = tpmod.tp_rank(cfg, mesh)
        self._tp_target = None if self.tp is None \
            else Shardings(mesh, tp_plan(cfg, mesh))

    def set_weights(self, params, version: Optional[int] = None):
        """Receives the trainer's weights, through int8 when ``quantize``
        (``ddma.quantize_dequant``, once per sync).  Versions only move
        forward: an older delivery is dropped."""
        if version is not None and version < self.weight_version:
            return
        if self.tp is not None:
            # int8's per-column scales span every row: quantize whole
            if self.quantize:
                params = ddma.quantize_dequant(ddma.whole(params))
            self.params = ddma.ddma_weight_sync(params, self._tp_target)
            if version is not None:
                self.weight_version = version
            return
        if self.mesh is not None:
            params = ddma.whole(params)
        self.params = ddma.quantize_dequant(params) if self.quantize \
            else params
        if version is not None:
            self.weight_version = version

    def begin_batch(self, batch_index: Optional[int] = None):
        """Sample a task batch, split its key and prefill.  Returns
        ``(job, state)`` ready for ``advance_chunk``."""
        assert self.params is not None, "weights never synchronized"
        if self.max_new <= 0:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        batch = self.tasks.sample(self.n_prompts, self.n_per_prompt)
        prompts = torch.as_tensor(batch.prompts, device=self.device)
        self.key, sub = prng.split(self.key)
        chunk = self.chunk or self.max_new
        n_chunks = -(-self.max_new // chunk)
        meta, tp = {"answers": batch.answers}, None
        if self.tp is not None:
            rows, tp = self.tp.for_rows(prompts.shape[0])
            prompts = prompts[rows]
            meta["row0"] = tp.row0
        state = start_rollout(self.params, self.cfg, prompts,
                              prompts.shape[1] + n_chunks * chunk, tp=tp)
        job = RolloutJob(
            batch_index=self.curr_step if batch_index is None
            else batch_index,
            params=self.params, weight_version=self.weight_version,
            key=sub, meta=meta,
            max_new=self.max_new, chunk=chunk, n_chunks=n_chunks)
        return job, state

    def begin_batch_pinned(self, batch_index: Optional[int] = None):
        """``begin_batch`` with the params snapshot *pinned* executor-side
        and replaced by a ``PinnedParams`` reference on the job.
        ``emit_batch`` releases the pin; a job dropped before emit must be
        handed to ``release_job`` (the scheduler's ``clear`` does)."""
        job, state = self.begin_batch(batch_index)
        self._pin_seq += 1
        self._pinned[self._pin_seq] = job.params
        job.params = PinnedParams(self._pin_seq)
        return job, state

    def _job_params(self, job):
        return self._pinned[job.params.key] \
            if isinstance(job.params, PinnedParams) else job.params

    def repin_job(self, job):
        """Re-snapshot an in-flight job's params on the current weights
        (re-admission after a respawn, ``core/supervise.py``).  Versions
        only move
        forward; the caller re-asserts the staleness bound."""
        if self.params is None:
            raise RuntimeError("repin before any weights were delivered")
        if self.weight_version < job.weight_version:
            raise RuntimeError(
                f"current version {self.weight_version} is older than the "
                f"job's admission version {job.weight_version}")
        if isinstance(job.params, PinnedParams):
            self._pinned.pop(job.params.key, None)
            self._pin_seq += 1
            self._pinned[self._pin_seq] = self.params
            job.params = PinnedParams(self._pin_seq)
        else:
            job.params = self.params
        job.weight_version = self.weight_version
        return job

    def release_job(self, job):
        """Release the pinned params of a job dropped without emitting (a
        no-op for unpinned jobs)."""
        params = getattr(job, "params", None)
        if isinstance(params, PinnedParams):
            self._pinned.pop(params.key, None)

    def pinned_count(self) -> int:
        """Live ``PinnedParams`` snapshots (the leak probe)."""
        return len(self._pinned)

    def advance_chunk(self, job, state):
        """One resumable ``rollout_chunk`` with the job's key discipline."""
        job.key, sub = prng.split(job.key)
        tp = None if self.tp is None \
            else dataclasses.replace(self.tp, row0=job.meta["row0"])
        state = rollout_chunk(self._job_params(job), self.cfg, state, sub,
                              n_steps=job.chunk, temperature=self.temperature,
                              tp=tp)
        job.chunks_done += 1
        return state

    def advance_chunk_rt(self, job, state):
        """``advance_chunk`` returning the job beside the state: the form
        ``ActorHandle.advance_chunk`` routes through."""
        return job, self.advance_chunk(job, state)

    def emit_batch(self, job, state):
        """Finalize and publish the completed batch."""
        state = finalize_rollout(state, job.max_new)
        if self.tp is not None:
            B = self.n_prompts * self.n_per_prompt
            state = state._replace(
                tokens=self.tp.gather_rows(state.tokens, B),
                behavior_logp=self.tp.gather_rows(state.behavior_logp, B))
        out = {
            "tokens": state.tokens,
            "behavior_logp": state.behavior_logp,
            "mask": action_mask(state),
            "prompt_len": state.prompt_len,
            "answers": job.meta["answers"],
            "weight_version": job.weight_version,
        }
        if isinstance(job.params, PinnedParams):
            self._pinned.pop(job.params.key, None)
        self.set_output("completions", out)
        return out

    def emit_batch_snapshot(self, job, state, names):
        """``emit_batch`` and an output-port snapshot in one endpoint."""
        self.emit_batch(job, state)
        return {n: self.get_output(n) for n in names}

    def step(self):
        job, state = self.begin_batch()
        for _ in range(job.n_chunks):
            state = self.advance_chunk(job, state)
        out = self.emit_batch(job, state)
        self.curr_step += 1
        return out

    # ------------------------------------- continuous-batching engine hooks --
    #
    # The engine (``repro_torch.rl.engine``) lives inside the executor: a
    # caller drives ``engine_enqueue`` / ``engine_round`` instead of the
    # begin/advance/emit chunk hooks, and rounds carry batch indices and
    # finished batches, never KV caches.

    def engine_configure(self, *, max_running_rows: int = 0,
                         row_budgets=None, round_delay_s: float = 0.0,
                         scorer: str = "numeric",
                         leave_one_out: bool = False,
                         kv_layout: str = "", kv_page_size: int = 0,
                         kv_pages: int = 0):
        """(Re)build the in-flight engine; a live engine's in-flight work
        is aborted first.  A rebuild starts with an empty radix cache in
        the paged layout."""
        if self.tp is not None:
            raise NotImplementedError(
                "the engine on a tensor-parallel mesh is not ported: a "
                "dense or MoE generator on a mesh with model > 1 serves "
                "through the chunk hooks")
        if self._engine is not None:
            self._engine.abort()
        self._engine = RolloutEngine(
            self, max_running_rows=max_running_rows,
            row_budgets=row_budgets, round_delay_s=round_delay_s,
            scorer=scorer, leave_one_out=leave_one_out,
            kv_layout=kv_layout, kv_page_size=kv_page_size,
            kv_pages=kv_pages)

    def engine_enqueue(self, batch_index: int, bound: int = 0) -> int:
        return self._engine.enqueue(batch_index, bound)

    def engine_round(self, names):
        """One engine tick; returns one item per emitted batch, shaped as
        a sample-queue entry with the output-port snapshot ``names``."""
        items = []
        for e in self._engine.round():
            self.set_output("completions", e["out"])
            items.append({
                "batch_index": e["batch_index"],
                "snapshot": {n: self.get_output(n) for n in names},
                "generator": self.name,
                "bound": e["bound"],
                "gen_busy_s": e["busy_s"],
                "gen_idle_s": 0.0,
                "_version": e["weight_version"],
            })
        return items

    def engine_inflight(self):
        return self._engine.inflight_batches()

    def engine_abort(self) -> int:
        return self._engine.abort() if self._engine is not None else 0

    def engine_stats(self):
        return self._engine.snapshot_stats() if self._engine is not None \
            else {}


class RewardExecutor(Executor):
    """Rule-based scorers and group-baseline advantages, on the host."""

    role = "reward"

    def __init__(self, *, n_per_prompt: int, scorer: str = "numeric",
                 leave_one_out: bool = False, name: str = "reward",
                 mesh=None):
        super().__init__(name, mesh)
        if n_per_prompt < 1:
            raise ValueError(f"n_per_prompt must be >= 1, got {n_per_prompt}")
        if leave_one_out and n_per_prompt < 2:
            raise ValueError(
                "leave_one_out needs n_per_prompt >= 2: the RLOO baseline "
                "averages the other n-1 samples of the group")
        self.n_per_prompt = n_per_prompt
        self.scorer = scorer
        self.leave_one_out = leave_one_out

    @staticmethod
    def _prompt_lens(prompt_len, batch_size: int) -> np.ndarray:
        """Accept a scalar or a per-sequence [B] array of prompt lengths."""
        if np.ndim(prompt_len) == 0:
            return np.full(batch_size, int(prompt_len), dtype=np.int64)
        lens = np.asarray(prompt_len).astype(np.int64).reshape(-1)
        if lens.shape[0] != batch_size:
            raise ValueError(
                f"prompt_len has {lens.shape[0]} entries for a batch of "
                f"{batch_size} sequences")
        return lens

    def step(self):
        comp = self.get_input("completions_with_ref") \
            or self.get_input("completions")
        toks = comp["tokens"].cpu().numpy()
        plens = self._prompt_lens(comp["prompt_len"], toks.shape[0])
        texts = [rl_data.decode_ids(t[p:]) for t, p in zip(toks, plens)]
        rewards = rl_rewards.score_group(comp["answers"], texts, self.scorer)
        adv = rl_rewards.group_advantages(rewards, self.n_per_prompt,
                                          self.leave_one_out)
        mask = comp["mask"]
        out = {
            "tokens": comp["tokens"],
            "behavior_logp": comp["behavior_logp"],
            "advantages": torch.as_tensor(adv, device=mask.device)[:, None]
            * mask,
            "mask": mask,
            "mean_reward": float(rewards.mean()),
        }
        if "ref_logp" in comp:
            out["ref_logp"] = comp["ref_logp"]
        self.set_output("completions_with_reward", out)
        self.curr_step += 1
        return out


class RefPolicyExecutor(Executor):
    """Frozen reference policy pi_base: per-token reference log-probs for
    the KL term.  Only the first weight sync sticks."""

    role = "reference"

    def __init__(self, cfg, *, name: str = "ref", mesh=None):
        super().__init__(name, mesh)
        self.cfg = cfg
        self.params = None
        # this rank of a tensor-parallel mesh (None: the whole tree)
        self.tp = tpmod.tp_rank(cfg, mesh)

    def set_weights(self, params, version: Optional[int] = None):
        if self.params is not None:
            return
        if self.tp is not None:
            self.params = ddma.ddma_weight_sync(
                params, Shardings(self.mesh, tp_plan(self.cfg, self.mesh)))
        else:
            self.params = ddma.whole(params) if self.mesh is not None \
                else params

    @torch.no_grad()
    def step(self):
        assert self.params is not None
        comp = self.get_input("completions")
        tokens = comp["tokens"]
        if self.tp is not None:
            # this rank's rows, heads, FFN columns and vocabulary slice;
            # the merged log-probs are whole rows, gathered over data
            B = tokens.shape[0]
            rows, tp = self.tp.for_rows(B)
            toks = tokens[rows]
            logits, _ = tpmod.forward_train(self.params, self.cfg,
                                            {"tokens": toks}, tp)
            lp = tp.gather_rows(
                tp.token_logprob(logits, toks[:, 1:],
                                 n_valid=toks.shape[1] - 1), B)
        else:
            logits, _ = forward_train(self.params, self.cfg,
                                      {"tokens": tokens})
            # the strided logits[:, :-1] goes to the kernel as it is
            lp = token_logprobs(logits[:, :-1], tokens[:, 1:])
        out = dict(comp)
        out["ref_logp"] = F.pad(lp, (1, 0))
        self.set_output("completions_with_ref", out)
        self.curr_step += 1
        return out


class TrainerExecutor(Executor):
    """Policy training: one AIPO update per step on scored completions.

    ``dtype`` is the params' dtype (fp32 by default, as in the reference);
    the Adam moments are fp32 whatever it is.  ``policy_model`` on the
    output port is the params after the latest step: the optimizer builds
    new tensors each step, so a snapshot taken from the port never
    changes afterwards.  With a ``mesh`` the state lives in shards placed
    by ``state_shardings`` and each step is ``make_sharded_train_step``;
    ``policy_model`` and ``get_model`` are the params whole."""

    role = "trainer"

    def __init__(self, cfg, *, lr=1e-3, rho=4.0, clip_mode="aipo",
                 kl_coef=0.0, seed=0, dtype=torch.float32,
                 device: DeviceLike = None, name: str = "trainer",
                 mesh=None):
        super().__init__(name, mesh)
        self.cfg = cfg
        self.state: Optional[TrainState] = None
        self.seed = seed
        self.dtype = dtype
        self.device = resolve(device)
        kw = dict(lr=lr, rho=rho, clip_mode=clip_mode, kl_coef=kl_coef)
        if mesh is None:
            self._train_step = make_train_step(cfg, **kw)
        else:
            from repro_torch.train.sharded import make_sharded_train_step
            self._train_step = make_sharded_train_step(cfg, mesh, **kw)
        self.metrics_history: List[Dict[str, float]] = []

    def init(self):
        state = init_train_state(self.cfg, self.seed, self.dtype,
                                 device=self.device)
        if self.mesh is not None:
            from repro_torch.train.sharded import shard_state
            state = shard_state(state, self.mesh)
        self.state = state
        self.set_output("policy_model", self.get_model())

    def get_model(self):
        """The params whole (gathered over the mesh, where there is one:
        a collective of its ranks)."""
        if self.mesh is None:
            return self.state.params
        return ddma.whole(self.state.params)

    def last_metrics(self) -> Dict[str, Any]:
        """The most recent train-step metrics row."""
        return dict(self.metrics_history[-1]) if self.metrics_history \
            else {}

    def recent_metrics(self, n: int):
        """The last ``n`` metrics rows."""
        return [dict(m) for m in self.metrics_history[-max(0, n):]]

    def step(self):
        scored = self.get_input("completions_with_reward")
        batch = {k: scored[k] for k in ("tokens", "behavior_logp",
                                        "advantages", "mask")}
        if "ref_logp" in scored:
            batch["ref_logp"] = scored["ref_logp"]
        self.state, metrics = self._train_step(self.state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["mean_reward"] = scored.get("mean_reward", 0.0)
        self.metrics_history.append(metrics)
        self.set_output("policy_model", self.get_model())
        self.curr_step += 1
        return metrics

    def save_checkpoint(self, path: str, step: int):
        """Write the params as ``{path}/{name}_{step}`` (``.npz`` and
        ``.json``, the JAX package's checkpoint format); on a mesh, every
        rank gathers them and the mesh's first rank writes."""
        from repro_torch.train.checkpoint import save_checkpoint
        params = self.get_model()
        if self.mesh is not None and \
                self.mesh.get_rank() != int(self.mesh.mesh.flatten()[0]):
            return
        os.makedirs(path, exist_ok=True)
        save_checkpoint(os.path.join(path, f"{self.name}_{step}"), params)
