"""Model import: TF GraphDef and ONNX into SameDiff graphs (port of
``deeplearning4j_tpu/modelimport``). Both importers read the files with
the port's own protobuf wire reader (``proto/wire.py``): importing and
using them loads neither TensorFlow nor protobuf. Keras ``.h5`` import is
not ported yet: ``KerasModelImport`` raises."""

from .onnx import OnnxFrameworkImporter  # noqa: F401
from .tensorflow import TensorflowFrameworkImporter  # noqa: F401


def _keras_not_ported():
    return NotImplementedError(
        "KerasModelImport is not in the PyTorch port yet (ROADMAP Queue 1 "
        "item 4, Keras): the port imports TF GraphDefs and ONNX models")


class _NotPorted(type):
    def __getattr__(cls, name):
        raise _keras_not_ported()

    def __call__(cls, *args, **kwargs):
        raise _keras_not_ported()


class KerasModelImport(metaclass=_NotPorted):
    """Keras ``.h5``/``.keras`` import, not in the port yet: every use
    raises ``NotImplementedError`` naming ROADMAP Queue 1 item 4. The JAX
    package reads ``.h5`` through h5py, which the card's machine lacks."""
