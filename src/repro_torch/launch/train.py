"""RL training launcher on the PyTorch port (the twin of the JAX package's
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch llama31-8b --smoke --steps 3 --transport shm --n-generators 2

Builds the paper's loop -- a generator pool, the rule-based reward, the
AIPO trainer and, with ``--kl-coef``, a frozen reference -- behind the
single controller, and runs it.  The executors run on ``--device``
(default ``cuda``).

``--transport proc`` hosts the trainer, every pool generator and the
reference each in its own spawned child, with its own interpreter lock,
CUDA context and stream; the reward stays in the controller process.
``--transport shm`` is the same placement with weight- and batch-sized
payloads moving over shared-memory rings.  ``--transport socket`` goes
across hosts: run

    python -m repro_torch.launch.train --listen 0.0.0.0:9001

on each actor host, then point the controller at them with ``--connect
host1:9001,host2:9001``: actors are assigned trainer first, then pool
generators, then the reference, and any actor beyond the list self-hosts
on localhost.  ``--child-devices N`` gives every spawned child the first
N cards (``CUDA_VISIBLE_DEVICES``).

``--supervise`` respawns a dead generator or reference from its spawn
spec with the latest weights replayed, up to ``--max-restarts`` times an
actor, then degrades the pool to the survivors; ``--chaos SPEC`` (or
``REPRO_CHAOS`` with ``--supervise``) injects scripted faults, e.g.

    python -m repro_torch.launch.train --arch llama31-8b --smoke \
        --steps 6 --transport proc --n-generators 2 --rollout-chunk 2 \
        --supervise --chaos "kill:generator1@batch=3,chunk=1"

and the supervisor's events are printed after the run.
``--checkpoint-every N`` writes the trainer's params to
``--checkpoint-path`` every N steps.  ``--arch`` names a config of the
registry (``repro_torch.configs.list_archs()``, all ten of the
reference's: the windowed dense archs, the MoE llama4-scout-17b-a16e,
the MLA + MTP deepseek-v3-671b, the VLM qwen2-vl-7b, the hybrid
zamba2-7b, the xLSTM xlstm-350m and the audio encoder-decoder
seamless-m4t-medium; default ``starcoder2-3b`` as in the reference) or
``llama31-8b``.  qwen2-vl-7b's generator needs patch embeddings and
seamless-m4t-medium's frame embeddings, which the executors do not carry
in either package, so their loops stop at the first generator step
(``KeyError``), as the reference's do.  xlstm-350m's mLSTM takes a
sequence of at most 64 tokens or a multiple of 64, in both packages.
``--child-mesh 1x4`` gives every spawned child a mesh of that shape
(``DeviceSpec.mesh_shape``, composing with ``--child-devices``): a child
whose mesh has more than one rank spawns the other ranks, one card each,
and runs its executor on all of them (``core/actors.py``); the trainer
then steps sharded over its mesh.
"""
from __future__ import annotations

import argparse
import functools
import json
import os

import torch

from repro_torch import configs
from repro_torch.core import (AdaptiveStalenessController, CommType,
                              CommunicationChannel, DeviceSpec,
                              ExecutorController, FaultPlan,
                              GeneratorExecutor, PoolConfig,
                              RefPolicyExecutor, RestartPolicy,
                              RewardExecutor, Supervisor,
                              TrainerExecutor, WeightsCommunicationChannel,
                              build_generator_pool, close_all_actors,
                              serve_actor_host, spawn_actor, spawn_all)
from repro_torch.kernels import build
from repro_torch.obs import trace as obs_trace
from repro_torch.rl.data import VOCAB_SIZE, ArithmeticTasks


def _parse_addr(s: str):
    host, _, port = s.strip().rpartition(":")
    return (host or "0.0.0.0", int(port))


def _parse_mesh(s: str):
    """'1x4' -> (1, 4)."""
    return tuple(int(p) for p in s.lower().split("x")) if s else ()


def config_for(args):
    """The model config of ``--arch``, or its smoke variant with
    ``--smoke``, from the registry as the reference reads it (llama31-8b
    from ``configs.llama_paper``)."""
    if args.arch == "llama31-8b":
        from repro_torch.configs.llama_paper import LLAMA31_8B, smoke
        cfg = smoke() if args.smoke else LLAMA31_8B
    else:
        cfg = (configs.get_smoke(args.arch) if args.smoke
               else configs.get_config(args.arch))
    if cfg.vocab < VOCAB_SIZE:
        raise ValueError("config vocab too small for the tokenizer")
    return cfg


def build_controller(cfg, args, *, trainer_cls=TrainerExecutor,
                     generator_cls=GeneratorExecutor,
                     ref_cls=RefPolicyExecutor):
    """The executors and channels behind the controller ``args`` asks
    for; remote actors are spawned here, each built by its factory
    (picklable for a remote transport)."""
    n_gens = max(1, args.n_generators)
    if (args.mode == "sync" or args.sequential) and n_gens != 1:
        raise ValueError("--n-generators > 1 needs the threaded async loop")
    spec = None
    if args.child_devices or args.child_mesh:
        spec = DeviceSpec(device_count=args.child_devices,
                          mesh_shape=_parse_mesh(args.child_mesh))
    # --connect addresses are taken trainer first, then generators, then
    # the reference; actors beyond the list self-host on localhost
    addrs = [_parse_addr(a) for a in args.connect.split(",")
             if a.strip()] if args.connect else []
    jobs = [functools.partial(
        spawn_actor, trainer_cls, cfg, lr=args.lr, rho=args.rho,
        clip_mode=args.clip_mode, kl_coef=args.kl_coef, seed=args.seed,
        device=args.device, transport=args.transport, device_spec=spec,
        address=addrs[0] if addrs else None),
        functools.partial(
        build_generator_pool, cfg, None,
        lambda g: ArithmeticTasks(prompt_len=args.prompt_len,
                                  max_operand=args.max_operand, ops="+-",
                                  seed=args.seed + g), n_generators=n_gens,
        generator_cls=generator_cls, seed=args.seed,
        n_prompts=args.n_prompts, n_per_prompt=args.n_per_prompt,
        max_new=args.max_new, temperature=args.temp,
        quantize=args.quantize_generator, chunk=args.rollout_chunk,
        device=args.device, transport=args.transport, device_spec=spec,
        addresses=addrs[1:1 + n_gens])]
    if args.kl_coef > 0:
        # paper Sec. 6: KL regularization against a frozen reference
        jobs.append(functools.partial(
            spawn_actor, ref_cls, cfg, transport=args.transport,
            device_spec=spec,
            address=addrs[1 + n_gens] if len(addrs) > 1 + n_gens else None))
    # a spawned child takes seconds to import torch and open its CUDA
    # context, so spawned children start at once; in-process actors, and
    # socket hosts (which take REPRO_SOCKET_ADDRS in order), in turn
    at_once = (args.transport or os.environ.get("REPRO_TRANSPORT")) \
        in ("proc", "shm")
    trn, (gens, _), *refs = spawn_all(jobs, at_once)
    channels = [WeightsCommunicationChannel("policy_model", trn, g)
                for g in gens]
    rew = RewardExecutor(n_per_prompt=args.n_per_prompt,
                         leave_one_out=args.rloo)
    executors = gens + [rew, trn]
    if refs:
        ref = refs[0]
        executors.insert(len(gens), ref)
        channels += [
            WeightsCommunicationChannel("policy_model", trn, ref),
            CommunicationChannel("completions", gens[0], ref,
                                 CommType.BROADCAST),
            CommunicationChannel("completions_with_ref", ref, rew,
                                 CommType.GATHER),
        ]
    else:
        channels.append(CommunicationChannel("completions", gens[0], rew,
                                             CommType.GATHER))
    channels.append(CommunicationChannel("completions_with_reward", rew,
                                         trn, CommType.SCATTER))
    adaptive = None
    if args.adaptive_staleness > 0:
        if args.mode != "async" or args.sequential:
            raise ValueError("--adaptive-staleness acts on the threaded "
                             "async loop only")
        if args.adaptive_staleness < args.staleness:
            raise ValueError(
                f"--adaptive-staleness ({args.adaptive_staleness}) is the "
                f"max bound and must be >= --staleness ({args.staleness})")
        adaptive = AdaptiveStalenessController(
            bound=args.staleness, min_bound=1,
            max_bound=args.adaptive_staleness)
    pool = None
    if args.engine:
        if args.mode != "async" or args.sequential:
            raise ValueError("--engine needs the threaded async loop")
        if args.rollout_chunk <= 0:
            raise ValueError("--engine decodes in rounds: set "
                             "--rollout-chunk >= 1")
        pool = PoolConfig(engine=True,
                          max_running_rows=args.max_running_rows,
                          kv_layout=args.kv_layout
                          or os.environ.get("REPRO_KV_LAYOUT", ""),
                          kv_page_size=args.kv_page_size,
                          kv_pages=args.kv_pages)
    supervise = None
    if args.supervise or args.chaos:
        chaos = FaultPlan.parse(args.chaos) if args.chaos \
            else FaultPlan.from_env()
        supervise = Supervisor(
            RestartPolicy(max_restarts=args.max_restarts), chaos=chaos)
    return ExecutorController(
        executors, channels, max_steps=args.steps, mode=args.mode,
        staleness=args.staleness, checkpoint_every=args.checkpoint_every,
        checkpoint_path=args.checkpoint_path, adaptive=adaptive,
        overlap_publish=not args.no_overlap_publish, pool=pool,
        supervise=supervise)


def run(args) -> dict:
    """Build and run the loop ``args`` describes; every remote actor is
    closed before this returns.  The result holds the history, the run's
    stats and the staleness histogram, and for a supervised run the
    supervisor's events."""
    if args.trace:
        # before any actor spawns: children read the boot flag, and the
        # environment covers anything started outside the boot path
        os.environ.setdefault(obs_trace.ENV_FLAG, "1")
        obs_trace.enable("controller")
    cfg = config_for(args)
    if torch.device(args.device).type == "cuda":
        # one nvcc a source here, not one a source in every child
        build.build_all(sorted(p.stem for p in build.CSRC.glob("*.cu")))
    ctl = build_controller(cfg, args)
    try:
        history = ctl.run_sequential() if args.sequential and \
            args.mode == "async" else ctl.run()
    finally:
        close_all_actors()               # join the remote executors
    out = {"history": history, "stats": ctl.stats,
           "staleness_hist": dict(ctl.staleness_hist)}
    if ctl.supervisor is not None:
        out["events"] = ctl.supervisor.events()
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="starcoder2-3b",
                    choices=configs.list_archs() + ["llama31-8b"],
                    help="model config: any arch of the registry, or "
                    "llama31-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the trainer and generators")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--mode", default="async", choices=["sync", "async"])
    ap.add_argument("--staleness", type=int, default=1)
    ap.add_argument("--clip-mode", default="aipo",
                    choices=["aipo", "ppo", "none", "is_unclipped"])
    ap.add_argument("--rho", type=float, default=4.0)
    ap.add_argument("--kl-coef", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--n-prompts", type=int, default=8)
    ap.add_argument("--n-per-prompt", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-operand", type=int, default=20)
    ap.add_argument("--temp", type=float, default=1.0)
    ap.add_argument("--rloo", action="store_true")
    ap.add_argument("--quantize-generator", action="store_true")
    ap.add_argument("--rollout-chunk", type=int, default=0)
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching rollout engine (needs "
                    "--rollout-chunk)")
    ap.add_argument("--max-running-rows", type=int, default=0,
                    help="engine slot-pool size (0 = 2x one batch's rows)")
    ap.add_argument("--kv-layout", default="",
                    choices=["", "dense", "paged"],
                    help="engine KV layout (default: $REPRO_KV_LAYOUT, "
                    "then dense)")
    ap.add_argument("--kv-page-size", type=int, default=0,
                    help="tokens per KV page (0 = 16)")
    ap.add_argument("--kv-pages", type=int, default=0,
                    help="KV arena pages shared by all rows (0 = every "
                    "slot fits a full row)")
    ap.add_argument("--n-generators", type=int, default=1,
                    help="generator pool size (async mode)")
    ap.add_argument("--transport", default=None,
                    choices=["inproc", "proc", "shm", "socket"],
                    help="actor placement (default: $REPRO_TRANSPORT or "
                    "inproc)")
    ap.add_argument("--listen", default="",
                    help="actor-host mode: serve executors to a remote "
                    "controller on HOST:PORT (port 0: any free port) and "
                    "never train here")
    ap.add_argument("--connect", default="",
                    help="comma-separated HOST:PORT actor hosts for "
                    "--transport socket, assigned trainer first, then "
                    "pool generators, then the reference")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="with --listen: the first N cards serve this "
                    "host's actors")
    ap.add_argument("--child-devices", type=int, default=0,
                    help="the first N cards for every spawned child actor")
    ap.add_argument("--child-mesh", default="",
                    help="mesh shape (e.g. '1x4') of every spawned child, "
                    "built from its own ranks and passed as its mesh=")
    ap.add_argument("--no-overlap-publish", action="store_true",
                    help="publish weights on the consumer thread instead "
                    "of the weight fabric's background publisher")
    ap.add_argument("--adaptive-staleness", type=int, default=0,
                    help="if > 0, the max bound for the adaptive "
                    "staleness controller")
    ap.add_argument("--supervise", action="store_true",
                    help="supervised run: a dead generator or reference is "
                    "respawned from its spawn spec with the latest weights "
                    "replayed, within a restart budget with capped "
                    "backoff; past the budget the pool degrades to the "
                    "survivors (default: fail fast on the first ActorDied)")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="restart budget of each actor with --supervise")
    ap.add_argument("--chaos", default="",
                    help="deterministic fault injection (implies "
                    "--supervise), e.g. 'kill:generator1@batch=2;"
                    "hang:generator0@batch=4:30'; with --supervise alone "
                    "$REPRO_CHAOS is read")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="write the trainer's params every N steps")
    ap.add_argument("--checkpoint-path", default="checkpoints",
                    help="directory of --checkpoint-every's files "
                    "({name}_{step}.npz and .json)")
    ap.add_argument("--trace", default="",
                    help="export a Chrome-trace JSON of the run to this "
                    "path: spans of the controller, pool workers, fabric "
                    "and every child on one timeline")
    ap.add_argument("--sequential", action="store_true",
                    help="run the async schedule on one thread")
    ap.add_argument("--out", default="",
                    help="write the history, stats and staleness "
                    "histogram as JSON to this path")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.listen:
        # actor-host mode: this process serves one executor a connection
        # until killed; its cards are fixed before torch touches CUDA
        if args.host_devices:
            DeviceSpec(device_count=args.host_devices).apply_env()
        host, port = _parse_addr(args.listen)
        serve_actor_host(host, port, ready=lambda p: print(
            f"actor host listening on {host}:{p}", flush=True))
        return None
    out = run(args)
    history, stats = out["history"], out["stats"]
    for h in history:
        print({k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in h.items()})
    print("stats:", {k: round(v, 3) for k, v in stats.items()})
    print("staleness_hist:", dict(sorted(out["staleness_hist"].items())))
    for e in out.get("events", ()):
        print("supervisor:", {k: (round(v, 4) if isinstance(v, float)
                                  else v) for k, v in e.items()})
    if args.trace:
        from repro_torch.obs.__main__ import summary_lines
        events = obs_trace.tracer().events()
        obs_trace.export(args.trace, events=events, metadata={
            "mode": args.mode, "steps": args.steps,
            "transport": args.transport or
            os.environ.get("REPRO_TRANSPORT", "inproc"),
            "n_generators": args.n_generators})
        print(f"trace: wrote {args.trace}")
        for line in summary_lines(events):
            print(line)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
