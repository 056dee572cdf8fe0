"""Parallel training of the port (counterpart of
``deeplearning4j_tpu/parallel``): ``ParallelWrapper`` (data-parallel
training with global BatchNorm moments, ZeRO-1 and bucketed, overlapped
gradient collectives, dense tensor parallelism), the ``torch.distributed``
launcher and meshes of ranks, ``TrainingCheckpointer``, and the serving
engines' quantized-params source (``placement.QuantizedParamsMixin``).

The exports load on first use, so that the layers and losses can import
``parallel.collectives`` (which imports only torch) without importing the
engines. Tensor-parallel serving and sequence parallelism come with
ROADMAP.md Queue 1 items 8b and 8c; ``ResiliencePolicy`` and
``run_resilient_fit`` with item 9.
"""

_EXPORTS = {
    "ParallelWrapper": "data_parallel", "make_mesh": "data_parallel",
    "make_dp_tp_mesh": "data_parallel",
    "HostShardedIterator": "launcher", "global_mesh": "launcher",
    "initialize": "launcher", "is_multi_host": "launcher",
    "make_global_array": "launcher", "process_count": "launcher",
    "process_index": "launcher", "shutdown": "launcher",
    "pod_mesh": "launcher",
    "TrainingCheckpointer": "checkpoint", "CorruptCheckpoint": "checkpoint",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
