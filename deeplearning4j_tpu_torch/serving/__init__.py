"""Serving fronts of the port: the bucketed InferenceEngine, the
coalescing ParallelInference, the generative fronts (contiguous, paged,
speculative), disaggregated serving (prefill and decode pools joined by
KV-page migration, and the router that owns admission) and the
JsonModelServer."""

from .disagg import (DisaggRouter, KVShipment,  # noqa: F401
                     PrefillReplica, RouterHandle, read_msg, write_msg)
