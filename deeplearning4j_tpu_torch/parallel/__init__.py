"""Parallel serving of the port (counterpart of
``deeplearning4j_tpu/parallel``). For now it holds the quantized-params
source the serving engines share (``placement.QuantizedParamsMixin``);
meshes and tensor parallelism come with ROADMAP.md Queue 1 item 8."""
