"""The port stands alone and keeps its device rule.

1. An AST scan: no module of ``deeplearning4j_tpu_torch`` and not
   ``chip_smoke.py`` imports ``jax``, ``jaxlib`` or ``deeplearning4j_tpu``
   (a scan and not ``sys.modules``: a process may have JAX loaded for
   other reasons, as the tests that compare the two packages do), and
   none imports ``h5py``, ``keras`` or ``tensorflow`` at module level (a
   test oracle may import one inside the call that uses it, as
   ``modelimport/validation.py`` does TensorFlow).
2. The device rule: with CUDA absent, every entry point raises unless the
   caller asks for ``cpu`` (the ComputationGraph, MultiLayerNetwork and
   serving fronts, SameDiff and its loaders, the BERT builders), and a
   non-CPU tensor never reaches K1's or K8's plain version (K3's:
   ``test_torch_flash_attention.py``).
3. The environment's precision policy and the dtype policy."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import dtypes, environment
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.kernels import affine_act as k1
from deeplearning4j_tpu_torch.kernels import lstm_cell as k8
from deeplearning4j_tpu_torch.models import (BertConfig, bert, bert_base,
                                             resnet, text_generation_lstm)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import fused_epilogues as fe
from deeplearning4j_tpu_torch.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.serving.batcher import ParallelInference
from deeplearning4j_tpu_torch.serving.engine import InferenceEngine
from deeplearning4j_tpu_torch.serving.server import JsonModelServer
from deeplearning4j_tpu_torch.utils import serializer
from deeplearning4j_tpu_torch.utils.convert import (from_numpy,
                                                    samediff_from_numpy)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu")


def _port_sources():
    files = sorted((ROOT / "deeplearning4j_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            yield node.args[0].value


def test_scan_covers_the_package():
    names = {p.name for p in _port_sources()}
    assert {"graph.py", "fused_epilogues.py", "affine_act.py", "engine.py",
            "chip_smoke.py", "samediff.py", "fusion.py", "flash_attention.py",
            "bert.py", "math.py", "reduce.py", "profile_bert.py",
            "lstm_cell.py", "pallas_kernels.py", "recurrent.py", "model.py",
            "zoo.py", "config.py", "serializer.py", "decode_attention.py",
            "attention.py", "sampling.py", "profile_generate.py",
            "kv_pool.py", "multiquery_decode.py", "layer_norm_act.py",
            "nnops.py", "lenet.py", "training.py", "mnist.py",
            "normalizers.py", "evaluation.py", "compare_kernels.py",
            "count_kernels.py", "hdf5.py", "keras.py", "conv_extra.py",
            "vertices.py", "make_keras_config.py", "disagg.py",
            "decode.py", "quantize.py", "placement.py",
            "quantization.py", "launcher.py", "data_parallel.py",
            "overlap.py", "checkpoint.py", "multihost_sim.py",
            "collectives.py"} <= names
    # both quantize modules: the ops' and the SameDiff rewrite's
    assert sum(p.name == "quantize.py" for p in _port_sources()) == 2


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted(n for n in _imports(tree) if _forbidden(n))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


ORACLES = ("h5py", "keras", "tensorflow")


def _module_level_imports(tree):
    """The imports a module runs when it is imported: its top level and
    class bodies, not the bodies of its functions."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield from _imports(ast.Module(body=[node], type_ignores=[])) \
            if isinstance(node, (ast.Import, ast.ImportFrom)) else ()
        if isinstance(node, ast.Call):
            yield from _imports(node)
        stack.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_oracle_at_module_level(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted(n for n in _module_level_imports(tree)
                 if any(n == f or n.startswith(f + ".") for f in ORACLES))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad} when imported"


# ---------------------------------------------------------------- devices

@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def cpu_net():
    return resnet(18, input_shape=(8, 8, 3), num_classes=3).init(
        device="cpu")


def test_init_without_device_raises(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet(18, input_shape=(8, 8, 3), num_classes=3).init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet(18, input_shape=(8, 8, 3), num_classes=3).init(device="cuda")


def test_fronts_without_device_raise(no_cuda, cpu_net):
    for make in (lambda: InferenceEngine(cpu_net),
                 lambda: InferenceEngine(cpu_net, quantize="int8"),
                 lambda: ParallelInference(cpu_net),
                 lambda: ParallelInference(cpu_net, quantize="int8"),
                 lambda: JsonModelServer(cpu_net)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_loaders_without_device_raise(no_cuda, cpu_net, tmp_path):
    path = tmp_path / "m.zip"
    cpu_net.save(str(path))
    for load in (lambda: serializer.load_model(str(path)),
                 lambda: ComputationGraph.load(str(path)),
                 lambda: from_numpy({}, {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load()
    back = serializer.load_model(str(path), device="cpu")
    assert back.device.type == "cpu"


def test_samediff_entry_points_without_device_raise(no_cuda, tmp_path):
    """SameDiff, its loaders, samediff_from_numpy and the BERT builders
    run on cuda unless asked for cpu, and raise without a card (the
    builder before it draws 110M random weights)."""
    cpu = SameDiff(device="cpu")
    cpu.constant("c", np.ones(2, np.float32))
    path = str(tmp_path / "sd.zip")
    cpu.save(path)
    graph = cpu.to_json()
    tiny = BertConfig(vocab_size=8, hidden_size=4, num_hidden_layers=1,
                      num_attention_heads=2, intermediate_size=8,
                      max_position_embeddings=4)
    for make in (SameDiff, SameDiff.create, lambda: SameDiff(device="cuda"),
                 lambda: SameDiff.from_json(graph),
                 lambda: SameDiff.load(path),
                 lambda: samediff_from_numpy(graph, {}),
                 lambda: bert(tiny, seq_len=4),
                 lambda: bert(tiny, seq_len=4, spelling="fusable"),
                 bert_base, lambda: bert_base(spelling="fusable")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert SameDiff.load(path, device="cpu").device.type == "cpu"
    assert bert(tiny, seq_len=4, device="cpu").device.type == "cpu"


def test_parallel_entry_points_without_device_raise(no_cuda, tmp_path):
    """ParallelWrapper, launcher.initialize and TrainingCheckpointer.restore
    run on cuda unless asked for cpu, and raise without a card (the
    wrapper for an uninitialized model, restore into one)."""
    from deeplearning4j_tpu_torch.parallel import launcher
    from deeplearning4j_tpu_torch.parallel.checkpoint import \
        TrainingCheckpointer
    from deeplearning4j_tpu_torch.parallel.data_parallel import \
        ParallelWrapper
    cpu = resnet(18, input_shape=(8, 8, 3), num_classes=3).init(
        device="cpu")
    with TrainingCheckpointer(str(tmp_path / "ck")) as ck:
        ck.save(cpu, step=1)
        fresh = resnet(18, input_shape=(8, 8, 3), num_classes=3)
        for make in (lambda: ParallelWrapper(fresh),
                     lambda: ParallelWrapper(cpu, device="cuda"),
                     launcher.initialize,
                     lambda: launcher.initialize("127.0.0.1:9", 2, 1),
                     lambda: ck.restore(fresh)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
        assert ParallelWrapper(cpu).device.type == "cpu"
        assert ck.restore(fresh, device="cpu") == 1
    assert fresh.device.type == "cpu"


def test_importer_entry_points_without_device_raise(no_cuda):
    """The TF and ONNX importers build their SameDiff on cuda unless asked
    for cpu, and raise without a card."""
    from deeplearning4j_tpu_torch.modelimport import (
        OnnxFrameworkImporter, TensorflowFrameworkImporter)
    fixtures = ROOT / "tests" / "fixtures"
    tf_path, onnx_path = fixtures / "tf_smoke.pb", fixtures / "onnx_smoke.onnx"
    for make in (lambda: TensorflowFrameworkImporter.import_file(tf_path),
                 lambda: TensorflowFrameworkImporter.import_graph_def(
                     tf_path.read_bytes(), trainable=True),
                 lambda: OnnxFrameworkImporter.import_file(onnx_path),
                 lambda: OnnxFrameworkImporter.import_model_proto(
                     onnx_path.read_bytes())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert TensorflowFrameworkImporter.import_file(
        tf_path, device="cpu").device.type == "cpu"
    assert OnnxFrameworkImporter.import_file(
        onnx_path, device="cpu").device.type == "cpu"


def test_keras_entry_points_without_device_raise(no_cuda):
    """KerasModelImport's four entry points build their network on cuda
    unless asked for cpu, and raise without a card."""
    from deeplearning4j_tpu_torch.modelimport import KerasModelImport as K
    fixtures = ROOT / "tests" / "fixtures"
    h5, v3 = str(fixtures / "keras_smoke.h5"), \
        str(fixtures / "keras_v3_lstm.keras")
    for make in (lambda: K.import_keras_model_and_weights(h5),
                 lambda: K.import_keras_model_and_weights(v3),
                 lambda: K.import_keras_sequential_model_and_weights(h5),
                 lambda: K.import_keras_model_configuration(h5),
                 lambda: K.import_keras_sequential_configuration(h5),
                 lambda: K.import_keras_model_and_weights(h5,
                                                          device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    for make in (K.import_keras_model_and_weights,
                 K.import_keras_sequential_model_and_weights,
                 K.import_keras_model_configuration,
                 K.import_keras_sequential_configuration):
        assert make(h5, device="cpu").device.type == "cpu"


def test_multilayer_entry_points_without_device_raise(no_cuda, tmp_path):
    """MultiLayerNetwork.init, its loaders, the engine over it and
    rnn_time_step run on cuda unless asked for cpu, and raise without a
    card (an uninitialized net's output and rnn_time_step initialize it
    on cuda first)."""
    tiny = lambda: text_generation_lstm(vocab_size=5, units=4)  # noqa: E731
    cpu = tiny().init(device="cpu")
    path = str(tmp_path / "mln.zip")
    cpu.save(path)
    x = np.zeros((1, 3, 5), np.float32)
    for make in (lambda: tiny().init(), lambda: tiny().init(device="cuda"),
                 lambda: MultiLayerNetwork.load(path),
                 lambda: serializer.load_model(path),
                 lambda: InferenceEngine(cpu),
                 lambda: tiny().rnn_time_step(x),
                 lambda: tiny().output(x)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    back = MultiLayerNetwork.load(path, device="cpu")
    assert back.device.type == "cpu"
    assert back.rnn_time_step(x[:, 0]).shape == (1, 5)
    assert InferenceEngine(back, device="cpu").output(x).shape == (1, 3, 5)


def test_lenet_entry_points_without_device_raise(no_cuda):
    """The zoo's lenet() and fit/score/evaluate of an uninitialized
    MultiLayerNetwork run on cuda unless asked for cpu, and raise without
    a card (fit initializes the net on cuda first)."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models import lenet, lenet_config
    x = np.zeros((2, 1, 28, 28), np.float32)
    y = np.eye(10, dtype=np.float32)[[1, 2]]
    for make in (lenet, lambda: lenet(device="cuda"),
                 lambda: MultiLayerNetwork(lenet_config()).fit(
                     DataSet(x, y)),
                 lambda: MultiLayerNetwork(lenet_config()).score(
                     DataSet(x, y)),
                 lambda: MultiLayerNetwork(lenet_config()).evaluate(x, y)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    net = lenet(device="cpu")
    assert net.device.type == "cpu"
    net.fit(DataSet(x, y))
    assert np.isfinite(net.score())


def test_generative_fronts_without_device_raise(no_cuda):
    """GenerativeEngine, ContinuousBatcher and a generative
    JsonModelServer run on cuda unless asked for cpu, and raise without a
    card; on the CPU they serve."""
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import (OutputLayer,
                                                    SelfAttentionLayer)
    from deeplearning4j_tpu_torch.serving.batcher import ContinuousBatcher
    from deeplearning4j_tpu_torch.serving.engine import GenerativeEngine
    conf = (NeuralNetConfiguration.builder().seed(0)
            .input_type(InputType.recurrent(6, 4))
            .list(SelfAttentionLayer(n_out=6, n_heads=2),
                  OutputLayer(n_out=6)).build())
    net = MultiLayerNetwork(conf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        net.decode_cache_spec(1, 8)  # an uninitialized net inits on cuda
    net.init(device="cpu")
    gen = dict(slots=1, max_cache_len=8, min_cache_len=8)
    for make in (lambda: GenerativeEngine(net),
                 lambda: ContinuousBatcher(net, **gen),
                 lambda: JsonModelServer(net, generate=gen)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    cb = ContinuousBatcher(net, device="cpu", **gen)
    try:
        assert len(cb.generate(tokens=[1, 2], max_new_tokens=3)["tokens"]) \
            == 3
    finally:
        cb.shutdown()


def test_paged_fronts_without_device_raise(no_cuda):
    """The paged engine, and the paged and speculative fronts, run on
    cuda unless asked for cpu, and raise without a card; on the CPU they
    serve."""
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import (OutputLayer,
                                                    SelfAttentionLayer)
    from deeplearning4j_tpu_torch.serving.batcher import ContinuousBatcher
    from deeplearning4j_tpu_torch.serving.engine import PagedGenerativeEngine
    conf = (NeuralNetConfiguration.builder().seed(0)
            .input_type(InputType.recurrent(6, 4))
            .list(SelfAttentionLayer(n_out=6, n_heads=2),
                  OutputLayer(n_out=6)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    gen = dict(slots=1, max_cache_len=16, min_cache_len=16, paged=True,
               page_size=8)
    for make in (lambda: PagedGenerativeEngine(net, pages=3, page_size=8),
                 lambda: ContinuousBatcher(net, **gen),
                 lambda: ContinuousBatcher(net, draft_model=net,
                                           speculate_k=2, **gen),
                 lambda: JsonModelServer(net, generate=dict(
                     gen, draft_model=net, speculate_k=2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    cb = ContinuousBatcher(net, device="cpu", draft_model=net,
                           speculate_k=2, **gen)
    try:
        assert len(cb.generate(tokens=[1, 2], max_new_tokens=3)["tokens"]) \
            == 3
        assert cb.stats()["speculative"]["proposed"] > 0
    finally:
        cb.shutdown()


def test_engine_device_must_match_model(cpu_net):
    with pytest.raises(ValueError, match="unsupported device"):
        InferenceEngine(cpu_net, device="meta")
    with pytest.raises(RuntimeError, match="init"):
        InferenceEngine(resnet(18, input_shape=(8, 8, 3), num_classes=3),
                        device="cpu")


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it walks the wrapper's
    CUDA branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda")


def _fake(t):
    return t.as_subclass(_FakeCuda)


@pytest.fixture
def plain_forbidden(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the plain version was reached")
    monkeypatch.setattr(k1, "affine_act_reference", boom)
    monkeypatch.setattr(_build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(_build, "_libs", {})


def test_cuda_tensor_never_reaches_the_plain_version(plain_forbidden):
    x, s, b = torch.ones(4, 8), torch.ones(8), torch.zeros(8)
    with pytest.raises(RuntimeError, match="nvcc"):
        k1.affine_act(_fake(x), _fake(s), _fake(b), "relu")
    fe.reset_counters()
    with pytest.raises(RuntimeError, match="nvcc"):
        fe.bn_act(_fake(torch.ones(2, 2, 2, 8)), _fake(s), _fake(b),
                  _fake(b), _fake(s), act="relu")
    assert fe.counters()["fused"] == 1
    with pytest.raises(ValueError, match="not supported"):
        k1.affine_act(torch.ones(4, 8, device="meta"), s, b, "relu")


def test_cuda_wrapper_checks_before_launch(plain_forbidden):
    x, s, b = torch.ones(4, 8), torch.ones(8), torch.zeros(8)
    with pytest.raises(TypeError, match="dtype"):
        k1.affine_act(_fake(x.double()), _fake(s), _fake(b))
    with pytest.raises(ValueError, match="contiguous"):
        k1.affine_act(_fake(torch.ones(8, 4).t()), _fake(s), _fake(b))
    with pytest.raises(ValueError, match="scale"):
        k1.affine_act(_fake(x), _fake(torch.ones(7)), _fake(b))
    with pytest.raises(ValueError, match="not in"):
        k1.affine_act(_fake(x), _fake(s), _fake(b), "swish")
    # an NHWC view of NCHW-contiguous memory is refused, not copied
    nchw = torch.ones(2, 8, 3, 3)
    with pytest.raises(ValueError, match="not contiguous"):
        fe.bn_act(_fake(nchw.permute(0, 2, 3, 1)), _fake(s), _fake(b),
                  _fake(b), _fake(s), act="relu")


@pytest.fixture
def k8_plain_forbidden(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the plain version was reached")
    monkeypatch.setattr(k8, "lstm_cell_reference", boom)
    monkeypatch.setattr(_build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(_build, "_libs", {})


def _k8_operands(B=2, F=3, U=4):
    return [torch.ones(s) for s in ((B, F), (B, U), (B, U), (F, 4 * U),
                                    (U, 4 * U), (4 * U,))]


def test_cuda_tensor_never_reaches_k8_plain_version(k8_plain_forbidden):
    ops = [_fake(t) for t in _k8_operands()]
    with pytest.raises(RuntimeError, match="nvcc"):
        k8.lstm_cell(*ops)
    pk.reset_counters()
    with pytest.raises(RuntimeError, match="nvcc"):
        pk.lstm_cell_fused(*ops, forget_bias=1.0)
    assert pk.counters() == {"fused": 1, "fallback_platform": 0}


def test_k8_wrapper_checks_before_launch(k8_plain_forbidden):
    x, h, c, w, rw, b = _k8_operands()
    with pytest.raises(TypeError, match="dtype"):
        k8.lstm_cell(*[_fake(t.double()) for t in (x, h, c, w, rw, b)])
    with pytest.raises(TypeError, match="every operand"):
        k8.lstm_cell(_fake(x), _fake(h.half()), *map(_fake, (c, w, rw, b)))
    with pytest.raises(ValueError, match="W must be contiguous"):
        k8.lstm_cell(*map(_fake, (x, h, c, torch.ones(16, 3).t(), rw, b)))
    with pytest.raises(ValueError, match="contiguous last dimension"):
        k8.lstm_cell(*map(_fake, (torch.ones(3, 2).t(), h, c, w, rw, b)))
    with pytest.raises(ValueError, match="shape"):
        k8.lstm_cell(*map(_fake, (x, h, c, w, rw, torch.ones(15))))


def test_cpu_tensor_takes_the_plain_version_uncounted():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
    s, b = torch.rand(8) + 0.5, torch.randn(8)
    k1.launches = 0
    for act in k1.ACTS:
        assert torch.equal(k1.affine_act(x, s, b, act),
                           k1.affine_act_reference(x, s, b, act))
    assert k1.launches == 0


# ------------------------------------------------------ environment, dtypes

@pytest.mark.parametrize("mode,device,tf32", [
    ("auto", "cuda", True), ("auto", "cpu", False), ("high", "cuda", True),
    ("highest", "cuda", False), ("highest", "cpu", False)])
def test_precision_policy_sets_and_restores_both_switches(mode, device,
                                                          tf32):
    env = environment.Environment.instance()
    old_mode = env.f32_matmul_precision
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    env.f32_matmul_precision = mode
    try:
        with environment.precision(device):
            assert torch.backends.cuda.matmul.allow_tf32 is tf32
            assert torch.backends.cudnn.allow_tf32 is tf32
    finally:
        env.f32_matmul_precision = old_mode
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == old


def test_dtype_policy_matches_jax():
    from deeplearning4j_tpu import dtypes as jdtypes
    assert dtypes.resolve("HALF") == torch.float16  # DL4J's name
    for name in ("FLOAT", "BFLOAT16", "FLOAT16", "DOUBLE", "INT32"):
        assert str(dtypes.resolve(name)).replace("torch.", "") == \
            np.dtype(jdtypes.resolve(name)).name
        assert dtypes.is_mixed(name) == jdtypes.is_mixed(name)
        assert str(dtypes.param_dtype(name)).replace("torch.", "") == \
            np.dtype(jdtypes.param_dtype(name)).name
    tree = {"a": {"w": torch.ones(2), "i": torch.ones(2, dtype=torch.int32)}}
    cast = dtypes.cast_floating(tree, "BFLOAT16")
    assert cast["a"]["w"].dtype == torch.bfloat16
    assert cast["a"]["i"].dtype == torch.int32
    assert dtypes.upcast_16(cast["a"]["w"]).dtype == torch.float32
