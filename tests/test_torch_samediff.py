"""The port's SameDiff, its op catalog and ``fuse_attention`` against the
JAX package, on the CPU.

1. Every op of the port's catalog against the JAX catalog's function of the
   same name on the same numpy inputs and keyword attributes (the names a
   recorded ``graph.json`` stores): equal dtypes, float32 values within
   rtol 1e-5 / atol 1e-6 (the same arithmetic in another library; linear
   algebra within 1e-4), integer and bool values equal.
2. ``graph.json`` and the ZIP round trip both ways with the JAX
   ``SameDiff``: a graph saved by one package loads in the other and gives
   the same outputs; the port's ``samediff_from_numpy`` carries a JAX graph
   and its values.
3. ``fuse_attention`` on shared graphs gives the JAX package's
   ``FusionReport`` (matched, unmatched, sites, reasons), the same fused
   op list, and the same outputs, including chains it must refuse.
4. What the port leaves out raises ``NotImplementedError``; control flow
   runs."""

import io
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import ops as jops
from deeplearning4j_tpu.autodiff import fusion as jfusion
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.autodiff import fusion
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.utils.convert import samediff_from_numpy

_R = np.random.default_rng(0)
A = _R.standard_normal((3, 4)).astype(np.float32)
B = _R.standard_normal((3, 4)).astype(np.float32)
POS = (np.abs(A) + 0.5).astype(np.float32)
UNIT = np.tanh(A).astype(np.float32)
C = _R.standard_normal((4, 5)).astype(np.float32)
X3 = _R.standard_normal((2, 3, 4)).astype(np.float32)
B3 = _R.standard_normal((2, 4, 5)).astype(np.float32)
I = _R.integers(-5, 6, (3, 4)).astype(np.int32)
J = (_R.integers(1, 4, (3, 4)) * np.where(_R.random((3, 4)) < 0.5, -1, 1)
     ).astype(np.int32)
M1 = A > 0
M2 = B > 0
NANS = A.copy()
NANS[0, 1], NANS[2, 3] = np.nan, np.inf
SPD = (C @ C.T + 4 * np.eye(4)).astype(np.float32)
VEC = _R.standard_normal(4).astype(np.float32)
VEC5 = _R.standard_normal(5).astype(np.float32)
IDX = np.array([[0, 2], [-1, 7]], np.int32)   # -1 wraps, 7 is out of range
IDX_ROW = np.array([[3, 0, -4, 9], [1, 1, 2, 2], [0, 3, 3, 1]], np.int32)
DATA = _R.standard_normal((6, 3)).astype(np.float32)
SEG = np.array([0, 2, 2, -1, 0, 7], np.int32)  # segment 1 stays empty
Q = _R.standard_normal((2, 2, 5, 4)).astype(np.float32)
KB = np.where(np.arange(5) < np.array([[3], [5]]), 0.0, -1e9).astype(
    np.float32)[:, None, None, :]
# a paged pool of 7 pages of 2 token rows (page 0 zero) and a table of 3
# pages a row, for the paged decode op
POOL = np.random.default_rng(21).standard_normal((14, 2, 4)).astype(
    np.float32)
POOL[:2] = 0.0
PT = np.array([[1, 2, 3], [6, 5, 4]], np.int32)
KEY = np.array([0, 7], np.uint32)
# one LSTM step: x [3, 5], h and c [3, 4], W [5, 16], RW [4, 16], b [16]
LSTM_ARGS = tuple(_R.standard_normal(s).astype(np.float32) for s in (
    (3, 5), (3, 4), (3, 4), (5, 16), (4, 16), (16,)))
# a Graves step (peepholes [3, 4]), a GRU step ([5, 12], [4, 12], b and the
# recurrent bias [12]) and an Elman step
GRAVES_ARGS = LSTM_ARGS + (_R.standard_normal((3, 4)).astype(np.float32),)
GRU_ARGS = tuple(_R.standard_normal(s).astype(np.float32) for s in (
    (3, 5), (3, 4), (5, 12), (4, 12), (12,), (12,)))
RNN_ARGS = tuple(_R.standard_normal(s).astype(np.float32) for s in (
    (3, 5), (3, 4), (5, 4), (4, 4), (4,)))
EMB_IDS = np.array([[0, 3, 2], [2, 2, 1]], np.int32)
ONEHOT = np.eye(4, dtype=np.float32)[[0, 3, 1]]
PROBS = (np.exp(A) / np.exp(A).sum(-1, keepdims=True)).astype(np.float32)
SIGM = (1 / (1 + np.exp(-A))).astype(np.float32)

# images [N, C, H, W] and channels-last, an OIHW kernel of 4 outputs, a
# depthwise kernel [C * 2, 1, 3, 3], and ONNX RNN operands (T 5, B 2, I 3,
# H 4: w [D, gates * H, I], r [D, gates * H, H], b [D, 2 * gates * H])
IMG = _R.standard_normal((2, 3, 7, 5)).astype(np.float32)
IMG_NHWC = np.ascontiguousarray(IMG.transpose(0, 2, 3, 1))
W_CONV = _R.standard_normal((4, 3, 3, 2)).astype(np.float32)
W_DW = _R.standard_normal((6, 1, 3, 3)).astype(np.float32)
# an int8 [in, out] weight and its per-output-channel f32 scales, for the
# quantized matmul the SameDiff weight rewrite records
_RQ = np.random.default_rng(22)
W_Q8 = _RQ.integers(-127, 128, (4, 5)).astype(np.int8)
W_Q8_SCALE = (np.abs(_RQ.standard_normal(5)) / 127 + 1e-3).astype(
    np.float32)


def _onnx_rnn_args(d, gates):
    return tuple(_R.standard_normal(s).astype(np.float32) for s in (
        (5, 2, 3), (d, gates * 4, 3), (d, gates * 4, 4), (d, 2 * gates * 4)))


ONNX_LSTM_ARGS = _onnx_rnn_args(1, 4)
ONNX_BILSTM_ARGS = _onnx_rnn_args(2, 4)
ONNX_GRU_ARGS = _onnx_rnn_args(1, 3)

CASES = [
    # pairwise
    ("math.add", (A, B), {}), ("math.add", (I, J), {}),
    ("math.sub", (A, B), {}), ("math.mul", (A, B), {}),
    ("math.div", (A, POS), {}), ("math.div", (I, J), {}),
    ("math.floordiv", (I, J), {}), ("math.floordiv", (A, POS), {}),
    ("math.mod", (I, J), {}), ("math.mod", (A, B), {}),
    ("math.pow", (POS, B), {}), ("math.maximum", (A, B), {}),
    ("math.minimum", (A, B), {}), ("math.atan2", (A, B), {}),
    ("math.rsub", (A, B), {}), ("math.rdiv", (POS, B), {}),
    ("math.squared_difference", (A, B), {}), ("math.fmod", (A, B), {}),
    # transforms
    ("math.neg", (A,), {}), ("math.neg", (I,), {}), ("math.abs", (I,), {}),
    ("math.abs", (A,), {}), ("math.sqrt", (POS,), {}),
    ("math.sqrt", (np.abs(I),), {}), ("math.square", (A,), {}),
    ("math.exp", (A,), {}), ("math.expm1", (A,), {}),
    ("math.log", (POS,), {}), ("math.log1p", (POS,), {}),
    ("math.log2", (POS,), {}), ("math.sin", (A,), {}),
    ("math.cos", (A,), {}), ("math.tan", (UNIT,), {}),
    ("math.asin", (UNIT,), {}), ("math.acos", (UNIT,), {}),
    ("math.atan", (A,), {}), ("math.sinh", (A,), {}),
    ("math.cosh", (A,), {}), ("math.floor", (A * 3,), {}),
    ("math.ceil", (A * 3,), {}), ("math.round", (A * 3,), {}),
    ("math.sign", (A,), {}), ("math.reciprocal", (POS,), {}),
    ("math.rsqrt", (POS,), {}), ("math.erf", (A,), {}),
    ("math.erfc", (A * 2,), {}),
    ("math.clip", (A,), {"min_value": -0.5, "max_value": 0.5}),
    ("math.clip_by_norm", (A,), {"clip_norm": 1.0}),
    ("math.clip_by_norm", (A,), {"clip_norm": 1.0, "axis": 1}),
    # comparisons and logic
    ("math.equal", (I, J), {}), ("math.not_equal", (I, J), {}),
    ("math.greater", (A, B), {}), ("math.greater_equal", (I, J), {}),
    ("math.less", (A, B), {}), ("math.less", (I, np.int32(2)), {}),
    ("math.less_equal", (I, J), {}), ("math.logical_and", (M1, M2), {}),
    ("math.logical_or", (M1, M2), {}), ("math.logical_not", (M1,), {}),
    ("math.logical_xor", (M1, M2), {}), ("math.isnan", (NANS,), {}),
    ("math.isinf", (NANS,), {}), ("math.where", (M1, A, B), {}),
    # blas / linalg
    ("linalg.mmul", (A, C), {}),
    ("linalg.mmul", (A, A), {"transpose_a": True}),
    ("linalg.mmul", (A, B), {"transpose_b": True}),
    ("linalg.mmul", (X3, B3), {}), ("linalg.mmul", (X3, C), {}),
    ("linalg.tensordot", (A, C), {"axes": 1}),
    ("linalg.tensordot", (X3, C), {"axes": [[2], [0]]}),
    ("linalg.einsum", (A, C), {"equation": "ij,jk->ik"}),
    ("linalg.outer", (VEC, VEC5), {}), ("linalg.diag", (VEC,), {}),
    ("linalg.diag", (SPD,), {}), ("linalg.diag_part", (SPD,), {}),
    ("linalg.trace", (SPD,), {}), ("linalg.inverse", (SPD,), {}),
    ("linalg.cholesky", (SPD,), {}), ("linalg.solve", (SPD, C), {}),
    ("linalg.det", (SPD,), {}), ("linalg.norm", (A,), {}),
    ("linalg.norm", (A,), {"axis": 1}),
    # shape
    ("shape.reshape", (A,), {"shape": [4, 3]}),
    ("shape.reshape", (X3,), {"shape": [-1, 2]}),
    ("shape.reshape_onnx", (X3,), {"shape": [0, -1]}),
    ("shape.reshape_onnx", (X3,), {"shape": [0, 0, 2, 2]}),
    ("shape.transpose", (X3,), {"axes": [2, 0, 1]}),
    ("shape.transpose", (A,), {}),
    ("shape.permute", (X3,), {"axes": [1, 2, 0]}),
    ("shape.squeeze", (A[None, :, None],), {}),
    ("shape.squeeze", (A[None],), {"axis": 0}),
    ("shape.expand_dims", (A,), {"axis": 1}),
    ("shape.expand_dims", (A,), {"axis": (0, 3)}),
    ("shape.expand_dims", (A,), {"axis": -1}),
    ("shape.concat", ([A, B],), {"axis": 1}),
    ("shape.stack", ([A, B],), {"axis": 0}),
    ("shape.concat_v", (A, B, A), {"axis": 0}),
    ("shape.stack_v", (A, B), {"axis": 2}),
    ("shape.flatten2d", (X3,), {}),
    ("shape.split", (X3, 2), {"axis": 2}),
    ("shape.split", (X3, [1, 3]), {"axis": 2}),
    ("shape.unstack", (X3,), {"axis": 1}),
    ("shape.tile", (A,), {"reps": [2, 1]}),
    ("shape.repeat", (A, 2), {"axis": 0}), ("shape.repeat", (A, 2), {}),
    ("shape.flip", (A,), {"axis": 1}), ("shape.flip", (A,), {}),
    ("shape.roll", (A, 1), {"axis": 1}), ("shape.roll", (A, 2), {}),
    ("shape.pad", (A,), {"pad_width": [[1, 0], [0, 2]]}),
    ("shape.pad", (A,), {"pad_width": 1, "constant_values": 3.0}),
    ("shape.broadcast_to", (VEC,), {"shape": [3, 4]}),
    ("shape.broadcast_to", (np.int32(0),), {"shape": [1, 5]}),
    ("shape.gather", (C, IDX), {"axis": 0}),
    ("shape.gather", (A, np.array([3, 0, -2], np.int32)), {"axis": 1}),
    ("shape.gather", (A, np.array([5, 11, 12], np.int32)), {}),
    ("shape.gather", (I, IDX), {"axis": 0}),
    ("shape.take_along_axis", (A, IDX_ROW), {"axis": 1}),
    ("shape.tril", (SPD,), {}), ("shape.triu", (SPD,), {"k": 1}),
    ("shape.strided_slice", (X3, [0, 1, 0], [2, 3, 4], [1, 1, 2]), {}),
    ("shape.strided_slice", (X3, [1, 2, 3], [-3, 0, 0], [-1, -1, -2]), {}),
    ("shape.strided_slice_v2", (X3,), {"spec": [
        ["index", 1], ["newaxis"], ["slice", None, None, -1], ["ellipsis"]]}),
    ("shape.strided_slice_v2", (X3,), {"spec": [
        ["ellipsis"], ["slice", 1, None, 2]]}),
    ("math.cast", (A * 3,), {"dtype": "int32"}),
    ("math.cast", (I,), {"dtype": "float32"}),
    ("math.cast", (A,), {"dtype": "bfloat16"}),
    ("math.cast", (I,), {"dtype": "bool"}),
    ("shape.shape_of", (X3,), {}),
    ("shape.one_hot", (np.array([0, 3, -1, 5], np.int32), 5), {}),
    # sort / scatter
    ("sort.sort", (A,), {}), ("sort.sort", (A,), {"axis": 0}),
    ("sort.argsort", (A,), {}), ("sort.top_k", (A, 2), {}),
    ("sort.in_top_k", (A, np.array([0, 3, 1], np.int32), 2), {}),
    ("scatter.update", (A, np.array([0, 2], np.int32), B[:2]), {}),
    ("scatter.add", (A, np.array([0, 2, 0], np.int32), B), {}),
    ("scatter.mul", (A, np.array([0, 2, 0], np.int32), B), {}),
    ("scatter.max", (A, np.array([0, 2, 0], np.int32), B), {}),
    ("scatter.segment_sum", (DATA, SEG, 4), {}),
    ("scatter.segment_mean", (DATA, SEG, 4), {}),
    ("scatter.segment_max", (DATA, SEG, 4), {}),
    ("scatter.segment_min", (DATA, SEG, 4), {}),
    ("scatter.segment_prod", (DATA, SEG, 4), {}),
    ("math.cumprod", (A,), {"axis": 1}), ("math.cumprod", (POS,), {}),
    # reductions
    ("reduce.sum", (A,), {}), ("reduce.sum", (A,), {"axis": 1,
                                                     "keepdims": True}),
    ("reduce.sum", (I,), {"axis": 0}), ("reduce.sum", (M1,), {}),
    ("reduce.mean", (X3,), {"axis": (2,), "keepdims": True}),
    ("reduce.mean", (I,), {}), ("reduce.max", (A,), {"axis": 0}),
    ("reduce.min", (M1,), {"axis": (0, 1)}), ("reduce.min", (I,), {}),
    ("reduce.prod", (A,), {"axis": 1}), ("reduce.prod", (X3,), {
        "axis": (0, 2), "keepdims": True}), ("reduce.prod", (I,), {}),
    ("reduce.std", (A,), {"axis": 0}), ("reduce.var", (A,), {}),
    ("reduce.argmax", (A,), {"axis": 1}), ("reduce.argmax", (A,), {}),
    ("reduce.argmin", (A,), {"axis": 0}),
    ("reduce.cumsum", (A,), {"axis": 0}), ("reduce.cumsum", (I,), {}),
    ("reduce.norm1", (A,), {"axis": 1}), ("reduce.norm2", (A,), {}),
    ("reduce.normmax", (A,), {"axis": 0, "keepdims": True}),
    ("reduce.logsumexp", (A,), {"axis": 1}),
    ("reduce.logsumexp", (X3,), {"axis": (0, 2), "keepdims": True}),
    # activations
    ("act.softmax", (A,), {"axis": 0}), ("act.logsoftmax", (A,), {}),
    ("act.gelu", (A,), {"approximate": False}),
    ("act.leakyrelu", (A,), {"alpha": 0.2}), ("act.elu", (A,), {"alpha": 0.5}),
    ("act.thresholdedrelu", (A,), {"theta": 0.3}),
    ("act.softmax_onnx_legacy", (X3,), {"axis": 1}),
    ("act.softmax_onnx_legacy", (X3,), {"axis": 2, "log": True}),
    # attention
    ("attention.fused_sdpa", (Q, Q, Q), {"scale": 0.5}),
    ("attention.fused_sdpa", (Q, Q, Q, KB), {"scale": 0.5}),
    # the decode graphs' ops: a cached step, a paged step and a paged
    # window of 2 rows (lengths before the step; page 0 is the zero page)
    ("attention.cached_sdpa", (Q[:, :, :1], Q[:, :, 1:2], Q[:, :, 2:3], Q,
                               Q[:, ::-1], np.array([1, 4], np.int32)),
     {"scale": 0.5}),
    ("attention.paged_sdpa", (Q[:, :, :1], Q[:, :, 1:2], Q[:, :, 2:3],
                              POOL, POOL[::-1], PT,
                              np.array([2, 5], np.int32)),
     {"scale": 0.5, "page_size": 2}),
    ("attention.paged_sdpa", (Q[:, :, :2], Q[:, :, 1:3], Q[:, :, 2:4],
                              POOL, POOL[::-1], PT,
                              np.array([0, 4], np.int32)),
     {"scale": 0.5, "page_size": 2}),
    # sampling: greedy, and draws a cold temperature or k = 1 makes
    # certain (the two packages' random streams differ)
    ("sampling.greedy", (A,), {}),
    ("sampling.categorical", (A, KEY), {"temperature": 1e-6}),
    ("sampling.top_k", (A, KEY), {"k": 1, "temperature": 1.0}),
    # losses (labels, logits)
    ("loss.softmax_ce_logits", (np.eye(4, dtype=np.float32)[[0, 3, 1]],
                                A), {}),
    ("loss.softmax_ce_logits", (np.eye(4, dtype=np.float32)[[2, 2, 0]],
                                A * 30), {}),
    ("loss.sigmoid_bce_logits", (M2.astype(np.float32), A), {}),
    ("loss.sigmoid_bce_logits", (UNIT, B * 40), {}),
    # the rest of the loss catalog (labels, predictions)
    ("loss.mcxent", (ONEHOT, PROBS), {}),
    ("loss.sparse_mcxent", (np.int32([0, 3, 1]), PROBS), {}),
    ("loss.binary_xent", (M2.astype(np.float32), SIGM), {}),
    ("loss.mse", (B, A), {}), ("loss.l2", (B, A), {}),
    ("loss.mae", (B, A), {}), ("loss.l1", (B, A), {}),
    ("loss.hinge", (np.where(M2, 1.0, -1.0).astype(np.float32), A), {}),
    ("loss.squared_hinge", (np.where(M2, 1.0, -1.0).astype(np.float32), A),
     {}),
    ("loss.kld", (ONEHOT * 0.9 + 0.025, PROBS), {}),
    ("loss.poisson", (np.abs(I).astype(np.float32), POS), {}),
    ("loss.cosine_proximity", (B, A), {}),
    ("loss.multi_label", (M2.astype(np.float32), A), {}),
    ("loss.wasserstein", (B, A), {}),
    ("loss.fmeasure", (M2.astype(np.float32)[:, :2], SIGM[:, :2]), {}),
    ("loss.mixture_density", (A[:, :2], np.concatenate([A, B], 1)[:, :8]),
     {}),
    # the catalog's ctc: optax's convention (logits, labels, paddings)
    ("loss.ctc", (X3, np.int32([[1, 2], [3, 3]])), {}),
    ("loss.ctc", (X3, np.int32([[1, 2], [3, 1]]), np.float32([[0, 0, 1],
                                                              [0, 0, 0]]),
                  np.float32([[0, 1], [0, 0]])), {"blank_id": 0}),
    # recurrence
    ("lstm_cell", LSTM_ARGS, {}), ("lstm_cell", LSTM_ARGS,
                                   {"forget_bias": 1.0}),
    ("graves_lstm_cell", GRAVES_ARGS, {}),
    ("gru_cell", GRU_ARGS, {}), ("gru_cell", GRU_ARGS[:5], {}),
    ("simple_rnn_cell", RNN_ARGS, {}),
    ("embedding_lookup", (C, EMB_IDS), {}),
    ("embedding_lookup", (C, EMB_IDS.astype(np.float32) + 0.5), {}),
    # normalization and the epilogues fuse_epilogues records
    ("layer_norm", (X3, VEC, B[0]), {}),
    ("layer_norm", (X3 * 3.0 + 2.0, VEC, B[0]), {"eps": 1e-3, "axis": -1}),
    ("epilogue.layer_norm_act", (X3, VEC, B[0]),
     {"eps": 1e-5, "act": "gelu"}),
    ("epilogue.layer_norm_act", (A, VEC, B[1]), {"act": "identity"}),
    ("epilogue.bias_act", (X3, VEC), {"act": "gelu_exact"}),
    ("epilogue.bias_act", (A, B[2]), {"act": "sigmoid"}),
    ("quantize.int8_mmul", (A, W_Q8, W_Q8_SCALE), {}),
    ("quantize.int8_mmul", (X3 * 50.0, W_Q8, W_Q8_SCALE), {}),
    # the nn ops the importers record ([N, C, H, W] images 2 x 3 x 7 x 5)
    ("conv2d", (IMG, W_CONV, VEC), {"stride": (2, 1), "mode": "same"}),
    ("conv2d", (IMG_NHWC, W_CONV), {"padding": (1, 0), "dilation": (2, 1),
                                    "data_format": "NHWC"}),
    ("conv2d", (IMG, W_DW[:6, :, :2]), {"groups": 3}),
    ("deconv2d", (IMG, W_CONV, VEC), {"stride": (2, 3), "padding": (1, 0),
                                       "dilation": (1, 2)}),
    ("deconv2d", (IMG_NHWC, W_CONV), {"stride": (3, 2), "mode": "same",
                                      "data_format": "NHWC"}),
    ("depthwise_conv2d", (IMG, W_DW), {"stride": (2, 1), "mode": "same"}),
    ("maxpool2d", (IMG,), {"kernel": (2, 2), "stride": (1, 2),
                           "padding": 1}),
    ("maxpool2d", (IMG_NHWC,), {"kernel": 3, "mode": "same",
                                "data_format": "NHWC"}),
    ("avgpool2d", (IMG,), {"kernel": (3, 2), "stride": (2, 2),
                           "padding": (1, 1), "count_include_pad": False}),
    ("avgpool2d", (IMG,), {"kernel": (3, 2), "padding": 1}),
    ("avgpool2d", (IMG_NHWC,), {"kernel": (3, 2), "stride": (2, 2),
                                "mode": "same", "data_format": "NHWC"}),
    ("batch_norm", (IMG, VEC[:3], B[0, :3], A[0, :3], POS[1, :3]),
     {"eps": 1e-3}),
    ("batch_norm", (IMG_NHWC, VEC[:3], B[0, :3], A[0, :3], POS[1, :3]),
     {"axis": -1}),
    ("instance_norm", (IMG, VEC[:3], B[0, :3]), {}),
    ("onnx_lstm", ONNX_LSTM_ARGS, {"hidden_size": 4}),
    ("onnx_lstm", ONNX_BILSTM_ARGS, {"direction": "bidirectional",
                                     "hidden_size": 4}),
    ("onnx_gru", ONNX_GRU_ARGS, {"direction": "reverse", "hidden_size": 4}),
    ("onnx_gru", ONNX_GRU_ARGS, {"hidden_size": 4,
                                 "linear_before_reset": 1}),
    # the resize ops: odd sizes up and down, both layouts
    ("image.resize_bilinear", (IMG_NHWC,), {"size": (11, 3)}),
    ("image.resize_bilinear", (IMG,), {"size": (3, 9),
                                       "data_format": "NCHW"}),
    ("image.resize_nearest", (IMG_NHWC,), {"size": (13, 4)}),
    ("image.resize_nearest", (IMG,), {"size": (14, 10),
                                      "data_format": "NCHW",
                                      "require_integer_upscale": True,
                                      "expect_leading": (2, 3)}),
    ("image.resize_scale", (IMG,), {"scale": (2.0, 3.0),
                                    "method": "bilinear",
                                    "data_format": "NCHW"}),
    ("image.resize_scale", (IMG_NHWC,), {"scale": (0.5, 0.7)}),
    ("image.resize_scale", (IMG_NHWC,), {"scale": (0.6, 1.4),
                                         "method": "bilinear"}),
] + [(f"act.{n}", (A,), {}) for n in (
    "identity", "relu", "relu6", "leakyrelu", "thresholdedrelu", "elu",
    "selu", "gelu", "swish", "mish", "sigmoid", "hardsigmoid", "tanh",
    "hardtanh", "rationaltanh", "recttanh", "softmax", "logsoftmax",
    "softplus", "softsign", "cube", "rrelu")]

_LINALG = ("linalg.inverse", "linalg.cholesky", "linalg.solve", "linalg.det")


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs in parallel workers: keep this module's torch CPU
    work to two threads, and restore the setting after it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _to_torch(a):
    if isinstance(a, list):
        return [_to_torch(x) for x in a]
    if isinstance(a, np.ndarray) or isinstance(a, np.generic):
        return torch.from_numpy(np.array(a))
    return a


def _to_jax(a):
    if isinstance(a, list):
        return [_to_jax(x) for x in a]
    if isinstance(a, (np.ndarray, np.generic)):
        return jnp.asarray(a)
    return a


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.dtype(x.dtype).name


def _as_np(x):
    if isinstance(x, torch.Tensor):
        x = x.float() if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


@pytest.mark.parametrize("name,args,attrs", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_op_matches_jax(name, args, attrs):
    fn, jfn = ops.lookup(name), jops.lookup(name)
    assert fn is not None and jfn is not None
    ops.mark_fwd_tested(name)
    got = fn(*_to_torch(list(args)), **attrs)
    want = jfn(*_to_jax(list(args)), **attrs)
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    tol = 1e-4 if name in _LINALG else 1e-5
    for g, w in zip(got, want):
        assert _dtype_name(g) == _dtype_name(w), name
        g, w = _as_np(g), _as_np(w)
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=tol, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)


def test_every_port_op_has_a_case_and_a_jax_name():
    names = set(ops.all_ops())
    assert names <= set(jops.all_ops())
    assert names == {c[0] for c in CASES}
    # the port's own ledger: marks of unregistered names do not count
    ops.mark_fwd_tested("math.add")
    ops.mark_grad_tested("math.not_an_op")
    assert "math.add" in ops.fwd_tested() <= names
    assert "math.not_an_op" not in ops.grad_tested()
    assert ops.get("math.erfc").category == "transform"
    assert not ops.get("math.less").differentiable


# ------------------------------------------------------------------- serde

def _jax_graph():
    """A small JAX graph: placeholders, a variable, scalar constants, a
    multi-output op, a bfloat16 constant, a reduction with a tuple axis."""
    rng = np.random.default_rng(1)
    sd = JSameDiff()
    x = sd.placeholder("x")
    ids = sd.placeholder("ids")
    w = sd.var("layer/W", rng.standard_normal((4, 6)).astype(np.float32))
    table = sd.constant("emb/table",
                        rng.standard_normal((9, 6)).astype(np.float32))
    half = sd.constant("half", jnp.asarray(rng.standard_normal(6),
                                           jnp.bfloat16))
    h = x.mmul(w) + sd.call("math.cast", half, dtype="float32")
    e = sd.call("shape.gather", table, ids, axis=0)
    h = sd.call("act.tanh", h + e.mean(axis=1))
    parts = sd.call_multi("shape.split", h, n_outputs=2,
                          name=["left", "right"], indices_or_sections=2,
                          axis=1)
    sd.call("math.mul", parts[0], parts[1] * 2.0, name="out")
    sd.call("reduce.mean", h, name="m", axis=(1,), keepdims=True)
    return sd


def _feeds():
    rng = np.random.default_rng(2)
    return {"x": rng.standard_normal((5, 4)).astype(np.float32),
            "ids": rng.integers(0, 9, (5, 3)).astype(np.int32)}


def test_jax_zip_loads_in_the_port(tmp_path):
    jsd = _jax_graph()
    path = str(tmp_path / "g.zip")
    jsd.save(path)
    sd = SameDiff.load(path, device="cpu")
    want = jsd.output(_feeds(), ["out", "m", "left"])
    got = sd.output(_feeds(), ["out", "m", "left"])
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-6)
    assert sd.get_value("half").dtype == np.float32  # bfloat16 -> numpy f32
    assert sd._values["half"].dtype == torch.bfloat16
    assert sd.variables() == jsd.variables() == ["layer/W"]


def test_port_zip_loads_in_jax(tmp_path):
    jsd = _jax_graph()
    sd = samediff_from_numpy(jsd.to_json(), {
        n: np.asarray(v) for n, v in jsd._values.items()}, "cpu")
    path = str(tmp_path / "p.zip")
    sd.save(path)
    back = JSameDiff.load(path)
    assert back.to_json() == jsd.to_json()
    want = jsd.output(_feeds(), ["out", "m"])
    got = back.output(_feeds(), ["out", "m"])
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]))
    assert np.asarray(back._values["half"]).dtype == jnp.bfloat16
    with zipfile.ZipFile(path) as zf:
        assert sorted(zf.namelist()) == ["graph.json", "value_names.json",
                                         "values.npz"]


def test_graph_json_round_trips_both_ways():
    jsd = _jax_graph()
    sd = SameDiff.from_json(jsd.to_json(), device="cpu")
    assert sd.to_json() == jsd.to_json()
    assert JSameDiff.from_json(sd.to_json()).to_json() == jsd.to_json()


def test_control_flow_records_load_save_but_do_not_run(tmp_path):
    """A JAX graph with a ``cond`` loads in the port with the same
    ``graph.json``, runs there with the JAX outputs, and the port's ZIP
    loads back in JAX (the records once only loaded here; they run since
    control flow is ported)."""
    jsd = JSameDiff()
    x = jsd.placeholder("x")
    p = jsd.placeholder("p")
    (y,) = jsd.cond(p, lambda sd, a: sd.call("math.neg", a),
                    lambda sd, a: a * 2.0, x, name="y")
    path = str(tmp_path / "cf.zip")
    jsd.save(path)
    sd = SameDiff.load(path, device="cpu")
    assert sd.to_json() == jsd.to_json()
    for pred, want in ((True, [-1.0, -1.0]), (False, [2.0, 2.0])):
        got = sd.output({"x": np.ones(2, np.float32), "p": np.array(pred)},
                        ["y"])["y"]
        np.testing.assert_array_equal(got, want)
    sd.save(path)
    back = JSameDiff.load(path)
    got = back.output({"x": np.ones(2, np.float32), "p": np.array(True)},
                      ["y"])["y"]
    np.testing.assert_array_equal(np.asarray(got), [-1.0, -1.0])


def test_recording_matches_jax():
    """The same builder calls record the same graph.json in both
    packages (sugar, fresh names, lifted constants)."""
    def build(sd):
        x = sd.placeholder("x")
        w = sd.var("w", np.ones((4, 3), np.float32))
        y = (x @ w) * 2.0 - 1.0
        y = sd.relu(y / 3.0) + (-y)
        y.reshape(3, -1).transpose().sum(axis=0, keepdims=True)
        sd.softmax(y)
        return sd
    got = build(SameDiff(device="cpu"))
    want = build(JSameDiff())
    assert got.to_json() == want.to_json()
    feeds = {"x": np.arange(8, dtype=np.float32).reshape(2, 4)}
    targets = [n for n, v in want._vars.items() if v.kind == "ARRAY"]
    g, w = got.output(feeds, targets), want.output(feeds, targets)
    for t in targets:
        np.testing.assert_allclose(g[t], np.asarray(w[t]), rtol=1e-6)


def test_output_runs_only_what_the_targets_need():
    sd = SameDiff(device="cpu")
    x = sd.placeholder("x")
    sd.placeholder("unused")
    y = sd.call("math.exp", x, name="y")
    sd.call("shape.reshape", y, name="broken", shape=[7, 7])
    out = sd.output({"x": np.zeros(3, np.float32)}, ["y"])
    np.testing.assert_array_equal(out["y"], np.ones(3, np.float32))
    with pytest.raises(ValueError, match="missing placeholder"):
        sd.output({}, ["y"])
    with pytest.raises(ValueError, match="unknown targets"):
        sd.output({"x": np.zeros(3, np.float32)}, ["nope"])
    with pytest.raises(ValueError, match="unknown op"):
        sd.call("math.nope", x)


def test_scalars_keep_their_rank():
    """A 0-d array stays 0-d on its way into the port (it came out 1-d,
    shape (1,), before: np.ascontiguousarray adds a dimension)."""
    from deeplearning4j_tpu_torch.utils.convert import tensor_from_numpy
    assert tensor_from_numpy(np.float32(2.0)).shape == ()
    assert tensor_from_numpy(np.asarray(3, np.int32)).dim() == 0
    sd = SameDiff(device="cpu")
    assert sd.constant("c", np.float32(2.0)).shape == ()
    assert sd.get_value("c").shape == ()


def test_values_follow_jax_dtype_rules():
    sd = SameDiff(device="cpu")
    sd.constant("f", 2.5)
    sd.constant("i", np.arange(3))
    sd.var("b", np.ones(2, bool))
    assert sd._values["f"].dtype == torch.float32
    assert sd._values["i"].dtype == torch.int32
    assert sd._values["b"].dtype == torch.bool
    sd.set_value("f", np.float64(1.5))
    assert sd._values["f"].dtype == torch.float32
    with pytest.raises(ValueError, match="already exists"):
        sd.constant("f", 1.0)


def test_what_is_not_ported_raises():
    """What the port leaves out of SameDiff's neighbourhood raises naming
    ROADMAP Queue 1: a Keras layer whose target kind is not ported yet
    (item 10; Keras import itself runs, ``test_torch_keras_import.py``);
    control flow, ``evaluate``, ``memory_report``, the 16-bit policy and
    remat, which raised here before, now run
    (``test_torch_samediff_controlflow.py``,
    ``test_torch_samediff_bf16_remat.py``)."""
    import json
    from deeplearning4j_tpu_torch.modelimport import KerasModelImport
    cfg = json.dumps({"class_name": "Sequential", "config": {"layers": [
        {"class_name": "InputLayer",
         "config": {"name": "in", "batch_shape": [None, 4]}},
        {"class_name": "LayerNormalization", "config": {"name": "ln"}}]}})
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        KerasModelImport.import_keras_model_configuration(cfg, device="cpu")
    sd = SameDiff(device="cpu")
    x = sd.placeholder("x")
    (y,) = sd.cond(x, lambda s, a: a, lambda s, a: a, x)
    assert sd.output({"x": np.array(True)}, [y.name])[y.name]
    assert sd.evaluate([], "x").confusion is None
    assert sd.set_dtype("BFLOAT16").dtype == "BFLOAT16"
    assert sd.set_dtype("FLOAT").dtype == "FLOAT"
    assert sd.set_workspace_mode("full").workspace_mode == "full"
    assert sd.set_workspace_mode("none").workspace_mode == "none"


# ------------------------------------------------------------------ fusion

def _attention_graph(sd, variant):
    """One attention chain per ``variant``, recorded through the builder
    API both packages share. Returns the feeds."""
    rng = np.random.default_rng(3)
    q = sd.placeholder("q")
    k = sd.placeholder("k")
    v = sd.placeholder("v")
    mask = sd.placeholder("mask")
    scale = sd.constant("scale", np.float32(2.0))
    eps = sd.constant("eps", np.float32(1e-9))
    if variant == "prescaled_q":
        q = sd.call("math.mul", q, sd.constant("qs", np.float32(0.5)),
                    name="q_scaled")
    s = sd.call("linalg.mmul", q, k, name="scores", transpose_a=False,
                transpose_b=variant != "bad_flags")
    if variant not in ("prescaled_q",):
        s = sd.call("math.div", s, scale if variant != "vector_scale"
                    else sd.constant("vscale", np.full(5, 2.0, np.float32)),
                    name="scaled")
    if variant == "mask_first":
        s = sd.call("math.add", mask, s, name="masked")
    else:
        s = sd.call("math.add", s, mask, name="masked")
    s = sd.call("math.add", s, eps, name="stable")
    p = sd.call("act.softmax", s, name="probs")
    p = sd.call("act.identity", p, name="dropout")
    sd.call("linalg.mmul", p, v, name="ctx", transpose_a=False,
            transpose_b=False)
    if variant == "fan_out":  # the probabilities also leave the chain
        sd.call("reduce.sum", p, name="probs_sum", axis=-1)
    feeds = {n: rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
             for n in ("q", "k", "v")}
    feeds["mask"] = np.where(np.arange(5) < np.array([[2], [5]]), 0.0,
                             -10000.0).astype(np.float32)[:, None, None, :]
    if variant == "bad_flags":  # k fed pre-transposed: mmul(q, k) plain
        feeds["k"] = np.ascontiguousarray(feeds["k"].swapaxes(-1, -2))
    return feeds


VARIANTS = ["plain", "mask_first", "prescaled_q", "fan_out", "bad_flags",
            "vector_scale"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_fuse_attention_report_matches_jax(variant):
    sd, jsd = SameDiff(device="cpu"), JSameDiff()
    feeds = _attention_graph(sd, variant)
    _attention_graph(jsd, variant)
    before = jsd.output(feeds, ["ctx"])["ctx"]
    rep, jrep = fusion.fuse_attention(sd), jfusion.fuse_attention(jsd)
    assert (rep.matched, rep.unmatched, rep.sites, rep.reasons, rep.kinds) \
        == (jrep.matched, jrep.unmatched, jrep.sites, jrep.reasons,
            jrep.kinds)
    assert sd.to_json() == jsd.to_json()
    expect = {"plain": 1, "mask_first": 1, "prescaled_q": 1}.get(variant, 0)
    assert rep.matched == expect
    if variant in ("fan_out", "vector_scale", "bad_flags"):
        assert rep.unmatched == 1 and len(rep.reasons) == 1
    got = sd.output(feeds, ["ctx"])["ctx"]
    np.testing.assert_allclose(got, np.asarray(jsd.output(feeds, ["ctx"])
                                               ["ctx"]), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(before), atol=1e-5)
    assert str(rep) == str(jrep)


def test_fused_graph_saves_and_loads_in_jax(tmp_path):
    sd = SameDiff(device="cpu")
    feeds = _attention_graph(sd, "plain")
    fusion.fuse_attention(sd)
    path = str(tmp_path / "fused.zip")
    sd.save(path)
    back = JSameDiff.load(path)
    assert [r.op for r in back._ops].count("attention.fused_sdpa") == 1
    np.testing.assert_allclose(
        np.asarray(back.output(feeds, ["ctx"])["ctx"]),
        sd.output(feeds, ["ctx"])["ctx"], atol=1e-5)


def test_npz_carrier_of_the_port_reads_back():
    from deeplearning4j_tpu_torch.utils import serializer
    tree = {"v0": torch.arange(4, dtype=torch.bfloat16),
            "v1": torch.ones(2, 3)}
    back = serializer._npz_bytes_to_tree(
        serializer._tree_to_npz_bytes(tree), "cpu")
    assert back["v0"].dtype == torch.bfloat16
    assert torch.equal(back["v0"], tree["v0"])
    with np.load(io.BytesIO(serializer._tree_to_npz_bytes(tree))) as z:
        assert "__dtypes__" in z.files
