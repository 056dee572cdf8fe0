"""Model import: Keras ``.h5``/``.keras`` into a MultiLayerNetwork or
ComputationGraph, and TF GraphDef and ONNX into SameDiff graphs (port of
``deeplearning4j_tpu/modelimport``). The importers read the files with the
port's own readers: HDF5 (``hdf5.py``) for Keras and the protobuf wire
format (``proto/wire.py``) for TF and ONNX. Importing and using them
loads neither h5py, Keras, TensorFlow nor protobuf."""

from .keras import KerasModelImport  # noqa: F401
from .onnx import OnnxFrameworkImporter  # noqa: F401
from .tensorflow import TensorflowFrameworkImporter  # noqa: F401
