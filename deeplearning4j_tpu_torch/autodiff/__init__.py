"""SameDiff graphs of the port: the graph container and its rewrite
passes (counterpart of ``deeplearning4j_tpu/autodiff``)."""
