"""A BERT encoder recorded as a SameDiff graph.

Counterpart of the JAX package's BERT serving path (``bench.py``
``_bert_freezer`` and ``_bert_sd``): there a HF ``TFBertModel`` is frozen to
a GraphDef, imported by ``TensorflowFrameworkImporter.import_graph_def``
and its attention chains fused. The card's machine has neither TensorFlow
nor ``transformers``, and a frozen full-width model is too large to keep
in the repository, so :func:`bert` records the graph that import makes:
the same catalog ops, named as the TF graph names them (from ``bert/``
on), with the weights under their HF variable names. The CPU tests hold
it against a real import of a small TFBert.

For fine-tuning, :func:`attach_classifier_head` adds the JAX package's
benchmark head (``bench.py`` ``_bert_sd``): the mean over the sequence,
a ``[hidden, n_classes]`` dense layer and ``loss.softmax_ce_logits``,
trained with ``Adam(2e-5)``; :func:`fine_tune_feeds` makes a batch with
``bench_bert``'s labels.

The ops of ``last_hidden_state``:

- embeddings: ``shape.gather`` of the word rows by ``input_ids``, of the
  position rows by ``expand_dims(range(T))`` and of the token-type rows by
  a ``[1, T]`` fill of zeros, added;
- LayerNorm in keras' folded form (``reduce.mean``, the ``act.identity``
  TF's StopGradient imports as, ``math.squared_difference``,
  ``reduce.mean``, ``+ eps``, ``math.rsqrt``, ``* gamma``, then
  ``x * inv + (beta - mean * inv)``);
- self-attention: the q/k/v projections, the head split
  (``shape.reshape_onnx`` to ``[B, T, heads, d]``, ``shape.transpose``),
  ``linalg.mmul(transpose_b)``, ``math.div`` by sqrt(d), ``math.add`` of
  the mask bias, ``math.add`` of HF's 1e-9, ``act.softmax``, the dropout
  ``act.identity``, ``linalg.mmul`` with v, and the head merge;
- the mask bias as HF spells it: ``(1 - cast(mask[B, 1, 1, T])) * -10000``;
- GELU as ``0.5 * x * erfc(-x * 0.70710677)``;
- the dropouts of inference as ``act.identity``.

``spelling="fusable"`` records the same encoder, with the same weights and
weight names and every other op the same, in the one spelling the JAX
package's ``autodiff/fusion.py::fuse_epilogues`` rewrites (its own tests
record it, ``tests/test_fused_epilogues.py::_record_ln_chain`` and
``_record_gelu_chain``):

- each LayerNorm in keras' folded form with ``axis=(-1,)`` and no
  StopGradient identity between the mean and ``math.squared_difference``;
- each GELU as ``(h * (1 + erf(h * 0.70710677))) * 0.5`` on the BiasAdd
  output.

It exists because it is the only way the JAX package reaches its
LayerNorm-epilogue kernels (K6 forward, K7 backward): on the ``"tf"``
spelling the matcher finds no site (the StopGradient identity hides the
mean, ``axis=(2,)`` cannot be checked against an unrecorded rank, and the
GELU anchor is ``math.erf`` where HF writes ``math.erfc``), and nothing
else in the JAX package records ``epilogue.layer_norm_act``. Fused
(``fuse_attention`` then ``fuse_epilogues``), a BERT-base graph in this
spelling runs 25 K6 (embeddings, then two per layer), 12 K1 (the
intermediate dense's bias + exact GELU) and 12 K3 launches per forward,
and K7, K2, K4 and K5 as many in a fine-tune step's backward. Its values
agree with the ``"tf"`` spelling's to float32 rounding (erf of ``u``
against erfc of ``-u``).

Where the import hard-codes the batch (its reshapes and the token-type
fill hold the frozen batch size), this graph keeps it free
(``shape.reshape_onnx``'s copied dims, a 3-D ``linalg.mmul`` in place of
TF's reshape/MatMul/reshape, a ``[1, T]`` fill that broadcasts), so one
graph serves every batch size at its sequence length ``seq_len``.

Weights are float32: normal(0, ``initializer_range``) for the kernels and
embedding tables, drawn with numpy from ``seed`` in the order of
:func:`weight_shapes`; zeros for biases and LayerNorm betas, ones for
gammas. Or taken from ``weights``, keyed by the HF variable names
(``TFBertModel.weights``: ``.../bert/embeddings/word_embeddings/weight:0``;
anything up to ``bert/`` and the ``:0`` are ignored).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np

from ..autodiff.samediff import SameDiff
from ..nn.updaters import Adam

INPUT_IDS = "input_ids"
ATTENTION_MASK = "attention_mask"
OUTPUT = "last_hidden_state"
LABELS = "labels"


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """HF ``BertConfig()`` geometry (bert-base-uncased) by default."""
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02


def weight_shapes(config: BertConfig) -> Dict[str, tuple]:
    """Every weight of ``last_hidden_state`` by its graph name (the HF
    name from ``bert/`` on, without ``:0``), in initialisation order."""
    H, I = config.hidden_size, config.intermediate_size
    out = {
        "bert/embeddings/word_embeddings/weight": (config.vocab_size, H),
        "bert/embeddings/token_type_embeddings/embeddings":
            (config.type_vocab_size, H),
        "bert/embeddings/position_embeddings/embeddings":
            (config.max_position_embeddings, H),
        "bert/embeddings/LayerNorm/gamma": (H,),
        "bert/embeddings/LayerNorm/beta": (H,),
    }
    for i in range(config.num_hidden_layers):
        p = f"bert/encoder/layer_._{i}"
        for proj in ("query", "key", "value"):
            out[f"{p}/attention/self/{proj}/kernel"] = (H, H)
            out[f"{p}/attention/self/{proj}/bias"] = (H,)
        out[f"{p}/attention/output/dense/kernel"] = (H, H)
        out[f"{p}/attention/output/dense/bias"] = (H,)
        out[f"{p}/attention/output/LayerNorm/gamma"] = (H,)
        out[f"{p}/attention/output/LayerNorm/beta"] = (H,)
        out[f"{p}/intermediate/dense/kernel"] = (H, I)
        out[f"{p}/intermediate/dense/bias"] = (I,)
        out[f"{p}/output/dense/kernel"] = (I, H)
        out[f"{p}/output/dense/bias"] = (H,)
        out[f"{p}/output/LayerNorm/gamma"] = (H,)
        out[f"{p}/output/LayerNorm/beta"] = (H,)
    return out


def _graph_name(hf_name: str) -> str:
    """``tf_bert_model/bert/x/y:0`` -> ``bert/x/y``."""
    name = hf_name.split(":")[0]
    at = name.find("bert/")
    return name[at:] if at >= 0 else name


def _init(config: BertConfig, seed: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in weight_shapes(config).items():
        leaf = name.rsplit("/", 1)[1]
        if leaf in ("kernel", "weight", "embeddings"):
            out[name] = rng.standard_normal(shape, dtype=np.float32) \
                * np.float32(config.initializer_range)
        elif leaf == "gamma":
            out[name] = np.ones(shape, np.float32)
        else:
            out[name] = np.zeros(shape, np.float32)
    return out


SPELLINGS = ("tf", "fusable")


def bert(config: BertConfig, seed: int = 0, weights: Optional[dict] = None,
         device=None, seq_len: int = 128, spelling: str = "tf") -> SameDiff:
    """The encoder's ``last_hidden_state`` graph for ``[B, seq_len]`` int32
    ``input_ids`` and ``attention_mask`` (any B), on ``device`` (``cuda``
    unless the caller asks for ``cpu``), in the TF importer's spelling
    (``"tf"``) or the one ``fuse_epilogues`` rewrites (``"fusable"``).
    Returns the unfused graph: apply ``autodiff.fusion.fuse_attention`` to
    serve it through K3, and on a ``"fusable"`` graph
    ``autodiff.fusion.fuse_epilogues`` to serve it through K6 and K1."""
    if spelling not in SPELLINGS:
        raise ValueError(f"spelling {spelling!r} not in {SPELLINGS}")
    if not 0 < seq_len <= config.max_position_embeddings:
        raise ValueError(f"seq_len {seq_len} outside 1.."
                         f"{config.max_position_embeddings}")
    H = config.hidden_size
    heads = config.num_attention_heads
    if H % heads:
        raise ValueError(f"hidden_size {H} is not a multiple of "
                         f"num_attention_heads {heads}")
    dh = H // heads
    sd = SameDiff(device)  # resolves (and checks) the device first
    shapes = weight_shapes(config)
    if weights is None:
        values = _init(config, seed)
    else:
        given = {_graph_name(k): np.asarray(v, np.float32)
                 for k, v in weights.items()}
        missing = sorted(set(shapes) - set(given))
        if missing:
            raise KeyError(f"weights lack {len(missing)} of the encoder's "
                           f"variables, e.g. {missing[:3]}")
        values = {n: given[n] for n in shapes}
        for n, shape in shapes.items():
            if values[n].shape != shape:
                raise ValueError(f"{n}: shape {values[n].shape}, expected "
                                 f"{shape}")

    w = {n: sd.var(n, values[n]) for n in shapes}
    f32 = np.float32
    op, const = sd.call, sd.constant

    def dense(x, prefix):
        y = op("linalg.mmul", x, w[f"{prefix}/kernel"],
               name=f"{prefix}/Tensordot/MatMul", transpose_a=False,
               transpose_b=False)
        return op("math.add", y, w[f"{prefix}/bias"],
                  name=f"{prefix}/BiasAdd")

    tf = spelling == "tf"
    axis = (2,) if tf else (-1,)

    def layer_norm(x, p):
        mean = op("reduce.mean", x, name=f"{p}/moments/mean", axis=axis,
                  keepdims=True)
        sg = op("act.identity", mean, name=f"{p}/moments/StopGradient") \
            if tf else mean
        sqd = op("math.squared_difference", x, sg,
                 name=f"{p}/moments/SquaredDifference")
        var = op("reduce.mean", sqd, name=f"{p}/moments/variance",
                 axis=axis, keepdims=True)
        eps = const(f"{p}/batchnorm/add/y", f32(config.layer_norm_eps))
        inv = op("math.rsqrt",
                 op("math.add", var, eps, name=f"{p}/batchnorm/add"),
                 name=f"{p}/batchnorm/Rsqrt")
        inv2 = op("math.mul", inv, w[f"{p}/gamma"], name=f"{p}/batchnorm/mul")
        mul_1 = op("math.mul", x, inv2, name=f"{p}/batchnorm/mul_1")
        mul_2 = op("math.mul", mean, inv2, name=f"{p}/batchnorm/mul_2")
        sub = op("math.sub", w[f"{p}/beta"], mul_2, name=f"{p}/batchnorm/sub")
        return op("math.add", mul_1, sub, name=f"{p}/batchnorm/add_1")

    def gelu(h, g):
        if tf:  # HF: 0.5 * h * erfc(-h / sqrt(2))
            half = op("math.mul", const(f"{g}/mul/x", f32(0.5)), h,
                      name=f"{g}/mul")
            u = op("math.mul", op("math.neg", h, name=f"{g}/Neg"),
                   const(f"{g}/Cast/x", f32(1.0 / math.sqrt(2.0))),
                   name=f"{g}/mul_1")
            return op("math.mul", half, op("math.erfc", u, name=f"{g}/Erfc"),
                      name=f"{g}/mul_2")
        # (h * (1 + erf(h / sqrt(2)))) * 0.5, fuse_epilogues' grouping "a"
        u = op("math.mul", h, const(f"{g}/Cast/x", f32(1.0 / math.sqrt(2.0))),
               name=f"{g}/mul_1")
        f = op("math.add", const(f"{g}/add/x", f32(1.0)),
               op("math.erf", u, name=f"{g}/Erf"), name=f"{g}/add")
        return op("math.mul", op("math.mul", h, f, name=f"{g}/mul"),
                  const(f"{g}/mul_2/y", f32(0.5)), name=f"{g}/mul_2")

    def heads_split(x, name):
        r = op("shape.reshape_onnx", x, name=f"{name}_reshape",
               shape=[0, 0, heads, dh])
        return op("shape.transpose", r, name=name, axes=[0, 2, 1, 3])

    ids = sd.placeholder(INPUT_IDS, shape=(None, seq_len))
    mask = sd.placeholder(ATTENTION_MASK, shape=(None, seq_len))

    # embeddings
    e = "bert/embeddings"
    words = op("shape.gather", w[f"{e}/word_embeddings/weight"], ids,
               name=f"{e}/Gather", axis=0)
    pos_ids = op("shape.expand_dims",
                 const(f"{e}/range", np.arange(seq_len, dtype=np.int32)),
                 name=f"{e}/ExpandDims", axis=0)
    pos = op("shape.gather", w[f"{e}/position_embeddings/embeddings"],
             pos_ids, name=f"{e}/Gather_1", axis=0)
    x = op("math.add", words, pos, name=f"{e}/add")
    fill = op("shape.broadcast_to", const("bert/Fill/value", np.int32(0)),
              name="bert/Fill", shape=[1, seq_len])
    types = op("shape.gather", w[f"{e}/token_type_embeddings/embeddings"],
               fill, name=f"{e}/Gather_2", axis=0)
    x = op("math.add", x, types, name=f"{e}/add_1")
    x = op("act.identity", layer_norm(x, f"{e}/LayerNorm"),
           name=f"{e}/dropout/Identity")

    # the extended attention mask, (1 - mask) * -10000 as [B, 1, 1, T]
    m4 = op("shape.reshape_onnx", mask, name="bert/Reshape",
            shape=[0, 1, 1, -1])
    mf = op("math.cast", m4, name="bert/Cast", dtype="float32")
    sub = op("math.sub", const("bert/Const", f32(1.0)), mf, name="bert/Sub")
    bias = op("math.mul", sub, const("bert/Const_1", f32(-10000.0)),
              name="bert/Mul")

    for i in range(config.num_hidden_layers):
        p = f"bert/encoder/layer_._{i}"
        a = f"{p}/attention/self"
        q = heads_split(dense(x, f"{a}/query"), f"{a}/transpose_2")
        k = heads_split(dense(x, f"{a}/key"), f"{a}/transpose")
        v = heads_split(dense(x, f"{a}/value"), f"{a}/transpose_1")
        s = op("linalg.mmul", q, k, name=f"{a}/MatMul", transpose_a=False,
               transpose_b=True)
        s = op("math.div", s, const(f"{a}/Cast/x", f32(math.sqrt(dh))),
               name=f"{a}/truediv")
        s = op("math.add", s, bias, name=f"{a}/Add")
        s = op("math.add", s, const(f"{a}/add_1/y", f32(1e-9)),
               name=f"{a}/add_1")
        probs = op("act.identity", op("act.softmax", s, name=f"{a}/Softmax"),
                   name=f"{a}/dropout/Identity")
        ctx = op("linalg.mmul", probs, v, name=f"{a}/MatMul_1",
                 transpose_a=False, transpose_b=False)
        ctx = op("shape.transpose", ctx, name=f"{a}/transpose_3",
                 axes=[0, 2, 1, 3])
        ctx = op("shape.reshape_onnx", ctx, name=f"{a}/Reshape_3",
                 shape=[0, 0, H])
        o = f"{p}/attention/output"
        y = op("act.identity", dense(ctx, f"{o}/dense"),
               name=f"{o}/dropout/Identity")
        x = layer_norm(op("math.add", y, x, name=f"{o}/add"),
                       f"{o}/LayerNorm")

        h = gelu(dense(x, f"{p}/intermediate/dense"),
                 f"{p}/intermediate/Gelu")
        o = f"{p}/output"
        y = op("act.identity", dense(h, f"{o}/dense"),
               name=f"{o}/dropout/Identity")
        x = layer_norm(op("math.add", y, x, name=f"{o}/add"),
                       f"{o}/LayerNorm")

    op("act.identity", x, name=OUTPUT)
    return sd


def bert_base(seed: int = 0, device=None, seq_len: int = 128,
              weights: Optional[dict] = None,
              spelling: str = "tf") -> SameDiff:
    """BERT-base (HF ``BertConfig()``: 12 layers, hidden 768, 12 heads,
    intermediate 3072, vocab 30522, 512 positions), float32, in either
    spelling of :func:`bert`."""
    return bert(BertConfig(), seed=seed, weights=weights, device=device,
                seq_len=seq_len, spelling=spelling)


def attach_classifier_head(sd: SameDiff, seed,
                           n_classes: int = 2) -> SameDiff:
    """The fine-tune head of ``bench.py`` ``_bert_sd`` on a graph of
    :func:`bert`: ``mean`` of ``last_hidden_state`` over the sequence,
    ``mmul`` with ``cls_W`` ([hidden, n_classes], normal(0, 0.02) from
    ``np.random.default_rng(seed)``, or from ``seed`` if it is a
    Generator), ``+ cls_b`` (zeros), and ``loss.softmax_ce_logits`` against
    the one-hot ``labels`` placeholder, set as the loss, with
    ``Adam(learning_rate=2e-5)`` as the updater."""
    rng = seed if isinstance(seed, np.random.Generator) \
        else np.random.default_rng(seed)
    width = sd._values["bert/embeddings/word_embeddings/weight"].shape[1]
    pooled = sd._vars[OUTPUT].mean(axis=1)
    w = sd.var("cls_W", rng.normal(0, 0.02, (width, n_classes))
               .astype(np.float32))
    b = sd.var("cls_b", np.zeros((n_classes,), np.float32))
    logits = pooled.mmul(w) + b
    labels = sd.placeholder(LABELS)
    sd.set_loss(sd.call("loss.softmax_ce_logits", labels, logits))
    sd.set_updater(Adam(learning_rate=2e-5))
    return sd


def fine_tune_feeds(rng, batch: int, seq: int, vocab: int = 30522,
                    n_classes: int = 2) -> dict:
    """One fine-tune batch: ``input_ids`` (uniform in 1..vocab-1, padding
    id 0 past each row's valid length), a ragged ``attention_mask`` (valid
    lengths uniform in 1..seq) and ``bench_bert``'s labels, the one-hot
    of ``input_ids.sum(axis=1) % n_classes``."""
    lengths = rng.integers(1, seq + 1, batch)
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(1, vocab, (batch, seq)).astype(np.int32) * mask
    labels = np.eye(n_classes, dtype=np.float32)[
        ids.sum(axis=1) % n_classes]
    return {INPUT_IDS: ids, ATTENTION_MASK: mask, LABELS: labels}
