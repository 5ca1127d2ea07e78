"""Lazy exports, as the JAX package's ``repro.core`` gives them (lazy to
avoid the aipo <-> executor <-> trainstep import cycles): the executors,
actors and transports, channels and weight fabric, controllers, the
generator pool, and supervision with fault injection."""
_EXPORTS = {
    "aipo_loss": "repro_torch.core.aipo",
    "importance_weights": "repro_torch.core.aipo",
    "token_logprobs": "repro_torch.core.aipo",
    "ActorDied": "repro_torch.core.actors",
    "ActorHandle": "repro_torch.core.actors",
    "DeviceSpec": "repro_torch.core.actors",
    "InprocTransport": "repro_torch.core.actors",
    "ProcTransport": "repro_torch.core.actors",
    "RemoteActorError": "repro_torch.core.actors",
    "ShmTransport": "repro_torch.core.actors",
    "SocketTransport": "repro_torch.core.actors",
    "Transport": "repro_torch.core.actors",
    "SpawnSpec": "repro_torch.core.actors",
    "as_handle": "repro_torch.core.actors",
    "close_all_actors": "repro_torch.core.actors",
    "serve_actor_host": "repro_torch.core.actors",
    "spawn_actor": "repro_torch.core.actors",
    "spawn_all": "repro_torch.core.actors",
    "serialize": "repro_torch.core.wire",
    "deserialize": "repro_torch.core.wire",
    "WeightFabric": "repro_torch.core.fabric",
    "CommType": "repro_torch.core.channels",
    "CommunicationChannel": "repro_torch.core.channels",
    "StagedWeights": "repro_torch.core.channels",
    "WeightsCommunicationChannel": "repro_torch.core.channels",
    "ExecutorController": "repro_torch.core.controller",
    "AsyncExecutorController": "repro_torch.core.controller",
    "SyncExecutorController": "repro_torch.core.controller",
    "AdaptiveStalenessController": "repro_torch.core.genpool",
    "FixedStaleness": "repro_torch.core.genpool",
    "GeneratorPool": "repro_torch.core.genpool",
    "build_generator_pool": "repro_torch.core.genpool",
    "PoolConfig": "repro_torch.core.genpool",
    "StalenessBuffer": "repro_torch.core.offpolicy",
    "PartialRolloutCache": "repro_torch.core.offpolicy",
    "Closed": "repro_torch.core.offpolicy",
    "Executor": "repro_torch.core.executor",
    "GeneratorExecutor": "repro_torch.core.executor",
    "RewardExecutor": "repro_torch.core.executor",
    "TrainerExecutor": "repro_torch.core.executor",
    "RefPolicyExecutor": "repro_torch.core.executor",
    "Supervisor": "repro_torch.core.supervise",
    "RestartPolicy": "repro_torch.core.supervise",
    "FaultPlan": "repro_torch.core.supervise",
    "Fault": "repro_torch.core.supervise",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        mod = importlib.import_module(_EXPORTS[name])
        return getattr(mod, name)
    raise AttributeError(name)
