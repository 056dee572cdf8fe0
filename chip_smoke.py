"""Drive the PyTorch/H100 port's serving, training, recurrent, generative
(disaggregated too), fused-epilogue, import, SameDiff and int8 serving
paths on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. toolchain: the card's name and power limit, torch, CUDA and nvcc;
2. build: every kernel source under ``deeplearning4j_tpu_torch/csrc``,
   one ``nvcc`` each, all started together;
3. kernel against plain: K1 (the BN-affine + activation epilogue) against
   its plain PyTorch version for all 7 activations in float32 and bfloat16
   at the 9 distinct ``[rows, C]`` shapes of ResNet-50 at batch 32 plus
   one ragged shape, and at LeNet's two (its convolutions' outputs at
   batch 125, with and without scale), a second run bitwise equal, with
   CUDA-event times beside the memory bound and ``torch.addcmul`` (the one
   PyTorch call computing the identity case);
4. serve: a full-width ResNet-50 (224x224x3, 1000 classes, float32, seed
   0, random weights, TF32 off) through ``InferenceEngine``: warm-up,
   ragged requests of 1, 3, 7 and 32 images with exactly 53 K1 launches
   per forward, and the card's output and ``avgpool`` activation against
   the port's plain path on the CPU for the same weights;
5. server: ``JsonModelServer`` on localhost answering POST /predict, each
   answer held against ``net.output``;
6. kernel-bwd against plain: K2 (the affine-epilogue backward) against its
   plain PyTorch version at the same 12 shapes, 7 activations, float32 and
   bfloat16, with and without ``scale``: ``dx``, ``dscale`` and
   ``dshift``, a second run bitwise equal, and CUDA-event times beside
   the memory bound;
7. train: a full-width ResNet-50 (224x224x3, 1000 classes, float32, seed
   0, the zoo's Adam(1e-3), TF32 off): one batch-4 step's loss, every
   parameter gradient and the new BN running statistics on the card
   against the port's plain path on the CPU; then ``fit`` on one fixed
   batch of 32 for 12 steps with exactly 53 K1 and 53 K2 launches each, a
   finite and falling loss, the step time, and a ``torch.profiler`` split
   of three steps (device time, K1 and K2 time); ``evaluate`` of the
   trained net on 3 batches of 32 (53 K1 a forward), its Evaluation the
   CPU plain path's up to near-ties; then transfer: the trained net through
   ``TransferLearning.GraphBuilder`` (frozen through ``s2_b5_out``, the
   end of its third stage; ``fc`` removed; a 10-class OutputLayer on
   ``avgpool``), 10 batch-32 ``fit`` steps with the K1 and K2 launches
   the fold plan implies (53 a forward: a frozen BN still runs K1; 10 a
   step: only stage 4's BNs run K2), every frozen parameter and running
   statistic bit-identical after ``fit``, the first 3 batches' gradients
   together by the float64 rule and the first 3 losses against the CPU,
   and
   ``evaluate``; then nchw: LeNet's first
   convolution in DL4J's channels-first layout (``ConvolutionLayer`` 20 x
   5x5, ReLU) and a ``BatchNormalization`` with a ReLU folded in, batch 64
   of 1 x 28 x 28, forward and backward, with exactly 2 K1 and 2 K2
   launches, one
   counted channels-last copy, and the output and every gradient against
   the CPU plain path; then lenet: zoo ``lenet()`` (conv 5x5 (20) -> max
   pool -> conv 5x5 (50) -> max pool -> dense 500 -> softmax 10, NCHW,
   Adam(1e-3), l2(5e-5), float32, seed 123) trained through
   ``MultiLayerNetwork.fit`` on synthetic MNIST: its first 3 batch-125
   steps on the card against the CPU plain path from the same weights
   (every parameter's gradient of the first batch within 5e-6 relative
   leaf by leaf, the losses within 1e-3), then 3 epochs of 8000 digits
   with 2 K1 + 2 K2 launches and one counted channels-last copy a step and
   only ``fused`` decisions, ``evaluate`` on 2000 test digits (2 K1 a forward)
   reaching at least 0.95, the step time, images/s and a
   ``torch.profiler`` split (device time, busy share of the unprofiled
   step, K1 and K2); then lenet-center: LeNet re-headed with
   ``CenterLossOutputLayer(n_out=10)``, 3 epochs through
   ``AsyncDataSetIterator(device_prefetch=True)`` (its first batches
   plain iteration's bit for bit), the first 3 losses and the centers
   after step 1 against the CPU, 2 K1 + 2 K2 a step, accuracy at least
   0.95; then the training modes of ``fit``: train-bf16 (zoo ResNet-50
   with ``data_type("BFLOAT16")`` from phase 7's initial weights, through
   the fused master-cast updater: f32 masters, updater state and BN
   statistics, one ``fused_updater`` decision, 53 bf16 K1 and 53 bf16 K2
   a step, the fused step against the unfused one over 3 steps by the
   determinism rule (bit for bit when two unfused runs repeat, else its
   distance to the nearer run within twice theirs), three runs of each in
   alternation with their step times, the batch-4 gradients by the
   float64 rule with the CPU bf16 error as the allowance's, 10 losses
   each within half the JAX band (rtol 7e-2, atol 5e-2) around the CPU
   plain path's bf16 losses from the same weights, phase 7's float32
   losses outside it, the share of the JAX band against those float32
   losses printed, and bf16 K1/K2 at the path's shapes against their
   plain versions and timed),
   train-accum (phase 7's net, ``accum_steps=4`` at batch 128: 4 x 53 K1
   and K2 a step, the accumulated batch-32 gradient by the float64 rule,
   peak memory beside a batch-32 step), remat (``workspace_mode`` "full"
   and "every_4" against "none": loss, gradients and new BN statistics
   by the determinism rule; one ``fit`` step from 0-set counts: the K1/K2
   launches the segment plan implies, ``fused`` only, the BN state it
   commits equal to its loss's within 1e-5 (committed once), its peak
   memory, and residual bytes),
   lenet-solver (LeNet with LBFGS(5) on 4 batches: the first batch's
   per-iteration losses within 1e-3 of the CPU's, every batch's loss
   falling, 2 K1 + 2 K2 a function evaluation) and lenet-on-device
   (``fit_on_device`` over the 8000 digits, 3 epochs: accuracy at least
   0.95, the first 3 losses within 1e-3 of per-batch ``fit``, at most 4
   synchronizing calls in the whole call);
8. kernel-attn against plain: K3 (the flash-attention forward) against its
   plain PyTorch version at (B, H, Tq, Tk, d) = (32, 12, 128, 128, 64),
   (1, 12, 128, 128, 64), ragged (2, 12, 77, 77, 64), (2, 4, 200, 200,
   128) and cross (3, 2, 16, 24, 32), with no bias, a ragged key bias and
   fully masked rows, in float32, bfloat16 and float16, on packed
   operands and on the head split of a ``[B, T, H*d]`` projection (the
   layout the BERT path gives): ``o``, ``m`` and ``l``, a second run
   bitwise equal, and CUDA-event times on the head-split layout beside the
   bound and ``scaled_dot_product_attention`` with the same float mask,
   with K3's registers, shared memory and CTAs an SM;
9. bert: BERT-base (HF ``BertConfig()``: 12 layers, hidden 768, 12 heads,
   float32, seed 0, random weights, TF32 off) recorded as a SameDiff
   graph, ``fuse_attention`` reporting 12 matched and 0 unmatched, then
   ``sd.output`` for requests of 1, 8 and 32 sequences of 128 tokens with
   ragged masks, each with exactly 12 K3 launches and no fallback
   decision; the card's ``last_hidden_state`` against the port's plain
   path on the CPU at batch 2; wall time, sequences per second and a
   ``torch.profiler`` split (device time, busy share, K3 time);
10. kernel-attn-bwd against plain: the flash-attention backward, K4 (dq)
    and K5 (dk, dv) fused into one kernel, against its plain PyTorch
    versions at phase 8's shapes, (2, 4, 96, 300, 32) (three key blocks:
    dq summed from per-block partials), (2, 3, 50, 70, 48) and (1, 2, 33,
    150, 96) (head dimensions below the kernel's padded width), its
    dtypes, layouts and
    masks (each fed K3's m and l and ``di = rowsum(o * do)``): a second
    run bitwise equal, the dq-only and dk/dv-only calls giving the same
    bits, and CUDA-event times in float32 and bfloat16 on the head-split
    layout beside the fused bound, the plain versions and the backward of
    ``scaled_dot_product_attention`` with the same float mask;
11. bert-fit: BERT-base as in phase 9 with the fine-tune head of
    ``bench.py`` ``_bert_sd`` (mean pool, 2 classes, softmax cross
    entropy, Adam(2e-5)); one batch-2 step's loss and every VARIABLE's
    gradient on the card against the port's plain path on the CPU (float32
    and float64 copies); then ``sd.fit`` on one fixed batch of 32 x 128
    (ragged masks) for 12 steps in one call, each step with exactly 12 K3
    and 12 fused K4+K5 launches (each writing dq, dk and dv) and only
    ``fused`` decisions, a finite and falling loss, the step time and a
    ``torch.profiler`` split (device time, busy share, K3 and K4+K5 time,
    top kernels) of 3 more steps;
12. kernel-lstm against plain: K8 (the LSTM step) against its plain
    PyTorch version at (B, F, U) = (32, 77, 256) and (32, 256, 256) (the
    two layers of TextGenerationLSTM at batch 32), (1, 77, 256), ragged
    (3, 50, 100) and (512, 512, 512) (above the reference's VMEM budget),
    in float32, bfloat16 and float16 with forget_bias 1.0, on contiguous
    and row-strided x: h' and c' within ``lstm_cell.tolerance``, a second
    run bitwise equal, and CUDA-event times at the path's shapes beside
    the bound, ``torch.lstm_cell`` (operands reordered outside the timed
    window) and an empty kernel launched with K8's grid, cluster and
    shared memory (the floor of any launch), with K8's cluster geometry,
    registers, shared memory, CTAs an SM and clusters the card holds;
13. lstm-serve: TextGenerationLSTM at the zoo's width (vocab 77, 2 x
    ``LSTM(256, use_pallas_cell=True)``, ``RnnOutputLayer(77)``, float32,
    seed 0, random weights, TF32 off) through ``InferenceEngine.output``:
    requests of 1, 8 and 32 one-hot sequences of 200 characters with
    ragged ``lengths`` (time bucket 256), each with exactly 2 x 256 K8
    launches and only ``fused`` decisions, with wall time, sequences and
    characters per second and a ``torch.profiler`` split (device time,
    busy share, K8 time); then greedy generation through ``rnn_time_step``
    (8 streams, a 50-character prompt, 300 characters, 2 K8 launches per
    step) matching ``output()`` on the generated text within 1e-6; the
    card's batch-2 output against the port's plain path on the CPU; and a
    whole-sequence ``torch.nn.LSTM`` on the batch-32 request as a
    yardstick;
14. lstm-fit: TextGenerationLSTM as in phase 13 built with
    ``tbptt_length(50)`` (DL4J's zoo ``TextGenerationLSTM.java``) and
    trained through ``MultiLayerNetwork.fit`` on 30 batches of 32 x 200
    one-hot characters of an order-2 Markov text (seed 0): the first
    batch's gradients against CPU float32 and float64 copies (phase 7's
    rule) and at least 100 times that allowance away from the CPU's
    full-BPTT gradient on every recurrent leaf (the truncation happened
    on the card); the first 3 losses within 1e-3 of the CPU plain path
    from the same weights; the last loss at most 0.9 of the first; 0 K8
    launches in ``fit`` (the gradient path runs the plain cell, as in the
    JAX package) and no other kernel; step time, characters per second
    and a ``torch.profiler`` split (device time, busy share, top
    kernels of one profiled step); then one batch-32 ``output`` of the
    trained net with exactly 2 x 256 K8 launches, ``fused`` only, within
    1e-4 of the CPU plain path;
15. rnn-breadth: ``GravesLSTM``, ``GRU`` (both forms), ``SimpleRnn``,
    ``Bidirectional`` (4 modes x both ``return_sequences``),
    ``ConvLSTM2D`` (two configurations), ``RecurrentAttentionLayer``,
    ``TimeDistributed``, ``RepeatVector``, ``MaskLayer``,
    ``MaskingLayer``, ``EmbeddingLayer`` and ``EmbeddingSequenceLayer``
    at a small size: one forward (ragged mask with a fully masked row)
    and one backward on the card, the output and every gradient within
    1e-5 of max |ref| of the CPU plain run on the same weights; and a
    ``Bidirectional(LSTM(use_pallas_cell=True))`` net's ``output`` with
    0 K8 launches;
16. kernel-decode against plain: K9 (single-query decode attention over
    a length-masked KV cache) against its plain PyTorch version at (B, H,
    C, d) = (8, 4, 128, 64) (the generative path's), (32, 4, 1024, 64),
    BERT-base heads (32, 12, 512, 64) and (32, 12, 4096, 64), (4, 8, 2048,
    128), a ragged (3, 2, 200, 32) and (32, 12, 64, 64) (split counts 2,
    5, 2, 2, 8, 4 and 1), with ragged lengths including 1, C and 0
    (uniform weights), in float32, bfloat16 and float16, with q packed and
    as the head split of a ``[B, 1, H*d]`` projection: within
    ``decode_attention.tolerance``, a second run bitwise equal, one device
    kernel a call at every split count (``torch.profiler``), and
    CUDA-event times at the path's shape and lengths and at (32, 12, 4096,
    64) beside the bound, the plain version,
    ``scaled_dot_product_attention`` with the float ``[B, 1, 1, C]``
    length mask and an empty kernel launched as K9 is (``floor_ms``);
17. kernel-mq-decode against plain: K10 (the speculative verify window,
    multi-query decode attention) against its plain PyTorch version at
    (B, H, k, C, d) = (8, 4, 4, 128, 64) (the speculative mix's), (32, 4,
    4, 1024, 64) (the speculative growth mix's largest cache), (32, 12,
    4, 4096, 64), windows of 2 and 8 at (8, 4, k, 512, 64), a C that is
    not a power of two, (3, 2, 4, 200, 32), and (32, 12, 4, 64, 64) (split
    counts 2, 5, 2, 8, 8, 4 and 1), with ragged lengths including 0, C - k
    and a row whose whole window is masked, in float32, bfloat16 and
    float16, with q packed and as the head split of a [B, k, H*d]
    projection: within ``multiquery_decode.tolerance``, a second run
    bitwise equal, one device kernel a call at every split count
    (``torch.profiler``), the bfloat16 tolerance rejecting a kernel that
    drops one split's keys, and CUDA-event times at the three first shapes
    beside the bound, the plain version, ``scaled_dot_product_attention``
    with the float ``[B, 1, k, C]`` window mask and an empty kernel
    launched as K10 is (``floor_ms``);
18. generate: the JAX package's generative-serving model
    (``tools/profile_generate.py``: V = 256, three ``SelfAttentionLayer(
    256, 4 heads)`` blocks, float32, seed 0, random weights, TF32 off):
    ``net.output`` on a batch-2 ragged request (3 K3 launches, ``fused``
    only) against the port's plain path on the CPU; greedy sampling on
    the card against ``np.argmax`` with ties; then
    ``ContinuousBatcher`` on the bench's mix (8 slots, cache bucket 128,
    the bench's 8 prompts of 56-64 tokens, 48 new tokens) with exactly 3
    K3 launches per prefill and 3 K9 launches per decode step (the engine
    counts both), only ``decode_fused`` and ``fused`` decisions, every
    stream teacher-forced through the CPU plain path, tokens per second,
    TTFT, TPOT and a ``torch.profiler`` split; then a growth mix (32
    slots, cache buckets 256 to 1024, prompts of 200-480 tokens, 256 new
    tokens) under the same gates, 4 streams teacher-forced;
19. generate-server: ``JsonModelServer(generate=...)`` on localhost, POST
    /generate for 3 prompts, each NDJSON stream equal to
    ``batcher.generate`` on the same prompt;
20. generate-paged: the bench's paged prefix mix (``ContinuousBatcher(
    paged=True, page_size=16)``, 65 pages, 8 streams of one 90-token system
    prompt, 16 new tokens each), 3 runs: one prefill (3 K3 launches) for
    the first admission, every other one a prefix hit, one copy-on-write
    fork per stream, 3 K9 launches per decode step, only ``fused`` and
    ``decode_fused`` decisions; the streams equal the contiguous batcher's
    on the card and each token the CPU plain path's teacher-forced argmax;
21. generate-spec: the speculative mix (the paged mix with
    ``draft_model=net, speculate_k=4``, 3 runs), the speculative growth mix
    (the growth mix made paged and speculative, 2 runs) and the speculative
    mix with a draft from another seed (1 run): 3 K10 launches per verify
    step, 3 K9 per draft step, only ``decode_multiquery``,
    ``decode_fused`` and ``fused`` decisions; every stream the plain greedy
    stream of the same mix (the paged mix's, the growth mix's) under the
    tie rule, and teacher-forced through the CPU plain path; the accept
    rate 1.0 with the target as its own draft (but at a near-tie, which is
    reported) and below 1.0 with the other draft; tokens per second, TTFT,
    TPOT, verify steps and a ``torch.profiler`` split (device time, busy
    share, K9, K10 and K3 time); then one POST /generate through a paged,
    speculative ``JsonModelServer``, its NDJSON stream equal to
    ``batcher.generate``;
22. kernel-ln and kernel-ln-bwd against plain: K6 (the LayerNorm +
    activation epilogue) and K7 (its backward) against their plain PyTorch
    versions at [rows, C] = (4096, 768) (BERT-base at batch 32), (256,
    768), (128, 768), ragged (77, 768), (4096, 1024), (33, 4096) and (5,
    37), all 7 activations, in float32, bfloat16 and float16: y, mu and
    rstd, then dx, dgamma and dbeta (K7 fed K6's mu and rstd) within
    ``layer_norm_act.tolerance``, a second run bitwise equal; rows of
    ``1000 + N(0, 1)``, where K6 holds and a one-pass variance in float32
    is rejected for every activation; CUDA-event times at (4096, 768)
    beside the bounds, the plain versions, ``F.layer_norm`` and
    ``native_layer_norm_backward`` (fed the same mean and rstd), K7 in
    float32 and bfloat16 beside an empty kernel launched as K7 is, with its
    registers, shared memory and CTAs an SM; one device
    kernel a K7 call at every shape and dtype (``torch.profiler``, a fresh
    process); and K1
    and K2 with the exact GELU at (4096, 3072), the fused graph's 12
    ``bias_act`` sites, against their plain versions in float32 and
    bfloat16 and beside their bounds and ``F.gelu(x + b)``;
23. bert-ln: BERT-base as in phase 9, recorded with
    ``spelling="fusable"``: ``fuse_attention`` 12 matched, 0 unmatched,
    ``fuse_epilogues`` 37 matched (25 ``layer_norm``, 12 ``gelu``), 0
    unmatched; ``sd.output`` for requests of 1, 8 and 32 sequences of 128
    tokens with ragged masks, each forward with exactly 25 K6, 12 K1 and 12
    K3 launches and only ``fused`` decisions; the card's batch-2
    ``last_hidden_state`` against the port's plain path on the CPU and
    against the same graph unfused on the card; wall time, sequences per
    second and a ``torch.profiler`` split (device time, busy share, K6, K1
    and K3 time); and the TF-spelled graph against the fused one at batch
    32, in turns;
24. bert-ln-fit: the fused graph of phase 23 with the fine-tune head of
    phase 11: one batch-2 step's loss and every VARIABLE's gradient on the
    card against the CPU (float32 and float64 copies, phase 11's rule);
    then ``sd.fit`` on one fixed batch of 32 x 128 for 12 steps, each with
    exactly 25 K6, 25 K7, 12 K1, 12 K2, 12 K3 and 12 fused K4+K5 launches
    and only ``fused`` decisions, a finite and falling loss, the step time
    and a ``torch.profiler`` split of 3 more steps;
25. import: every committed ``tests/fixtures/tf_*.pb`` and ``onnx_*.onnx``
    through the port's importers (its own protobuf wire reader) on the
    card, the records the CPU import's and the outputs within the JAX
    corpus test's tolerances of the port's CPU plain path and of the
    recorded outputs; ``tf_while.pb``'s loop on the card; ``fuse_attention``
    on the imported ONNX transformer block with the JAX package's report
    (0 matched: the export spells k^T apart); neither TensorFlow, protobuf
    nor h5py loaded;
26. sd-control: a SameDiff graph with ``cond``, ``while_loop`` and
    ``scan`` on the card against the CPU plain path, outputs and the
    gradients through ``cond`` and ``scan``, both predicates;
27. bert-bf16-fit: the fused BERT-base of phase 24 (its weights after
    that phase) through ``SameDiff.fit`` under ``set_dtype("BFLOAT16")``:
    the first 32 x 128 step's gradients against the CPU's float64, each
    within 4 times the CPU plain path's bf16 error (8 where the gradient
    lies below bf16's rounding) and their median at least a quarter of
    it, a gate the card's float32 step must fail; 3
    steps at batch 2 each within half the JAX bf16 band (rtol 7e-2, atol
    5e-2) around the CPU plain path's bf16 losses from the same weights,
    one ``fused_updater`` decision; then fit steps of 32 x 128, each with
    12 K1, 12 K2, 12 K3, 12 K4+K5, 25 K6 and 25 K7 launches, all bfloat16,
    ``fused`` only, float32 masters; the step and device time, each
    kernel's bf16 device time a step beside phase 24's float32 and its
    bf16 bound, and the device kernels of one bf16 and one float32 step
    in a fresh process;
28. bert-remat: the same graph in float32 under workspace modes "none"
    (three runs), "full" and "every_4", 2 fit steps each from the same
    weights: K1, K3 and K6 twice a forward's launches under remat, the
    losses and new values by the determinism rule, the peak memory
    ("full" below "none") and ``memory_report``'s residual bytes and
    segment count;
29. bert-eval: ``SameDiff.evaluate`` of the BERT-base classifier over 3
    batches of 8 x 128 (12 K1, 12 K3 and 25 K6 a forward), its confusion
    matrix the CPU plain path's up to near-ties;
30. keras-import: every committed Keras fixture (4 ``.h5``, 2
    ``.keras``) read by the port's own HDF5 reader and imported through
    ``KerasModelImport`` on the card and on the CPU (the same
    configuration), the card's output against the CPU plain path and the
    recorded outputs (``import_smoke_io.npz`` rtol 1e-4 / atol 1e-4,
    ``import_corpus_io.npz`` rtol 2e-4 / atol 2e-5), 2 K1 a forward of
    ``keras_smoke.h5`` and 0 of ``keras_sepdw.h5`` (the counts
    ``tests/test_torch_keras_import.py`` holds against the JAX
    package's), no K8 in an imported LSTM, then 16 K8 a request of
    ``keras_lstm.h5`` with ``use_pallas_cell=True`` (2 layers x the
    engine's time bucket 8), and neither h5py, Keras nor TensorFlow
    loaded;
31. keras-golden: ``tests/golden_harness.py::run_keras_imported`` on the
    card (``keras_smoke.h5``, Sgd(0.05), 8 batch-16 steps), the losses and
    parameter summaries within ``keras_imported_golden.json``'s bands
    (rtol 1e-3, atol 1e-5), 2 K1 and 2 K2 a step;
32. keras-resnet50: the committed Keras ResNet-50 configuration
    (``tests/fixtures/keras_resnet50_config.json``, 177 layers, 25.6 M
    parameters) imported config-only with seeded Keras-layout weights
    through the importer's weight path: served at batch 32 x 224 x 224 x 3
    (106 K1 a forward: 53 convolution biases and 53 BatchNormalizations,
    the 33 BN + ReLU pairs folded, the 16 ReLUs after an Add apart), the
    batch-2 output and ``avg_pool`` against the CPU plain path; then
    fine-tuned with its ``predictions`` Dense re-headed as an OutputLayer
    (its weights kept), 3 batch-32 ``fit`` steps with Sgd, 106 K1 and 106
    K2 a step, the first step's loss against the CPU's float64 loss, the
    step and device time and the busy share;
33. disagg: disaggregated serving on phase 18's generative model (full
    width, float32): the bench's mixed load (6 interactive streams of
    8-token prompts x 16 new tokens beside 6 prompts of 112 tokens x 2
    new tokens, cache 128, pages of 16 rows) through one colocated paged
    ``ContinuousBatcher`` and through a ``PrefillReplica`` feeding a decode
    ``ContinuousBatcher(migrate_buckets=[7])``, in 3 interleaved rounds
    of fresh prompts: every long prompt's ``KVShipment`` through a
    ``socket.socketpair()`` (``to_bytes``, ``write_msg``, ``read_msg``,
    ``from_bytes``) bit for bit, every split stream equal to the
    colocated one (under the tie rule) and teacher-forced through the CPU
    plain path, 3 K3 a prefill and 3 K9 a decode step on each side, no
    decode-side prefill for a migrated request and the adopted pages the
    shipped ones; the interactive TTFT p50/p99 of each side and their p99
    ratio, TPOT p50, the export and import ms, bytes and wire MB/s of the
    shipments, and one profiled window a side (device ms, busy share);
    then ``DisaggRouter`` over the replica and two decode replicas on the
    growth mix's 32 prompts x 64 new tokens, twice: 32 prefills and 32
    migrations (the pages adopted the pages shipped, no decode-side
    prefill), then 32 resident-prefix hits with no prefill or migration,
    every stream equal to the first pass's and to a colocated paged
    ``ContinuousBatcher``'s on the same mix, and teacher-forced through
    the CPU plain path;
34. sd-decode: ``tests/test_generative_decode.py``'s mini transformer
    stacked 12 times at BERT-base's attention shape (H 12, d 64):
    ``fuse_attention`` 12 matched, ``rewrite_for_decode`` contiguous and
    paged (pages of 16 rows); a prefill of 8 ragged prompts of 100-128
    tokens (12 K3), 32 decode steps (12 K9 each) into a cache of 256, and
    on the paged replay a window of 4 rows through ``attention.
    paged_sdpa`` (12 K10); every output within 1e-4 of the base graph
    recomputed over the full prefix on the card, and of the CPU plain
    path's decode graphs;
35. int8-mm: ``torch._int_mm``'s shape rules read off the card (raw
    probes), then the int8 contraction (``ops/quantize.py``) at every
    distinct convolution shape of ResNet-50 at batch 32 (im2col + the
    int8 GEMM), at BERT-base's dense shapes at 32 x 128 and at the
    generative model's decode rows (8 slots): each int32 accumulator bit
    for bit with the plain float64 contraction on the card, each
    ``int8_conv`` / ``int8_matmul`` on float32 input the CPU's bit for bit
    on its first rows, the contraction's and the int8 call's times beside
    the float32 ``F.conv2d`` / ``torch.matmul`` and the int8 bound;
36. int8-resnet50: zoo ResNet-50 (uncut, seed 0) through
    ``InferenceEngine(quantize="int8")`` warmed at [1, 8, 32]: batch-32
    requests with exactly 53 K1 launches a forward (the JAX package's
    epilogue count for the quantized conf) and no other kernel, one
    ``conv`` decision a convolution and one ``dot`` a forward, no quantize
    fallback, no cold bucket; the batch-2 output against the port's int8
    CPU path (``INT8_CPU_REL_TOL``); ``quantization_gate`` (int8 vs f32,
    label-free) on 256 seeded images at JAX's default bound 0.01; weight
    bytes, wall and device ms, the busy share, and f32 and int8 requests
    in turns;
37. int8-generate: phase 18's generative model through
    ``ContinuousBatcher(quantize="int8", kv_cache="int8")`` on the bench
    mix (3 K3 a prefill, 3 K9 a step) and on the paged prefix mix with
    speculation (3 K10 a verify window, the f32 draft's 3 K9 a step): an
    engine walk of 8 streams x 24 steps whose every step's logits lie
    within 0.05 of the f32 full-prefix recompute (JAX's bound) and whose
    tokens are the port's int8 CPU path's wherever its top-2 margin
    exceeds that bound, the card's logits within the same bound of the
    CPU int8 path's, ``cache_bytes`` and the pool under half of f32's,
    one int8 ``KVShipment`` through a socketpair and imported into a
    fresh int8 pool bit for bit; tokens/s, TTFT and TPOT beside the f32
    mix's;
38. int8-bert: BERT-base in the ``"fusable"`` spelling after
    ``fuse_epilogues``, then ``quantize_weights``: 72 sites matched (6 a
    layer, the JAX pass's count on the tiny graph), 0 skipped, no site's
    shape changed; requests of 32 x 128 with exactly 12 K3, 25 K6 and 12
    K1 launches a forward and ``dot`` decisions only; the batch-2 output
    against the port's int8 CPU path and both int8 outputs against f32
    within JAX's int8 bound 0.05 (``INT8_KV_REL``), the weight bytes saved
    and the times beside the f32 graph's;
39. data-parallel training (ResNet-50 from the zoo, uncut, seed 0,
    Adam(1e-3), float32, TF32 off; ranks spawned through
    ``parallel/multihost_sim.py`` after the build, a float64 CPU
    reference of the same steps running beside them): [dp-resnet50] 3
    batch-32 steps on 2 ranks sharing the card over gloo (16 rows each)
    and on 1 rank over NCCL, params and BN running statistics (their
    change from the initial state) against float64 within max(1e-3, 2 x
    the single-process card ``fit``'s own error), the ranks bit-identical
    after every step, 53 K1 and 53 K2 a step on every rank with only
    fused decisions, a ragged global batch of 31 against the unpadded
    single-process ``fit`` the same way, step ms, collective ms and bytes
    a step; [dp-zero1] ``shard_update=True, overlap_grads=True`` on 2
    ranks bit for bit the replicated 2-rank run, the per-rank Adam state
    half of it, ``accum_steps=2`` within the gate; [dp-tp] the
    ``[2048, 1000]`` head column-sharded over a (1, 2) mesh within the
    gate; [dp-checkpoint] 4 ZeRO-1 steps on 2 ranks saving asynchronously
    at steps 2 and 4 (and a ZIP at step 2), step 2 restored in one rank
    and continued 2 steps bit for bit against the ZIP's continuation, the
    newest step torn and the restore falling back, and an
    ``InferenceEngine`` warmed from the directory serving a batch of 32
    bit for bit the restored net's output (53 K1); save latency and bytes;
40. summary: a ``{"kernels": [...]}`` line (K1-K10), the ``nvidia-smi``
    name and power limit, and last ``{"ok": true, "device": {...}}``.

The serving path (phases 4-5), the training path, the NCHW block,
LeNet's fit and evaluation and the five training modes (phase 7), the BERT
serving path (phase 9), the BERT fine-tune path (phase 11), the LSTM
serving path and the LSTM streaming path (phase 13), the LSTM training
path and the trained net's request (phase 14), the recurrent family
(phase 15), the two generative
mixes (phase 18), the generative server (phase 19), the paged mix (phase
20), the three speculative runs and the speculative server (phase 21),
the fused BERT serving path (phase 23), the fused BERT fine-tune path
(phase 24), the import path (phase 25), the bf16 fine-tune (phase 27),
each workspace mode's steps (phase 28), ``evaluate`` (phase 29), the
Keras imports (phase 30), the Keras golden replay (phase 31), the
Keras ResNet-50's requests and fine-tune steps (phase 32), each window
of the mixed load and each router pass (phase 33) and each prefill,
decode step and window of the decode graphs (phase 34), the int8
ResNet-50 requests (phase 36), the two int8 generative mixes (phase 37),
the int8 BERT requests (phase 38) and each data-parallel step of every
rank (phase 39) are each driven with the launch counts set to 0 just
before and read just after.

The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import atexit
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

#: ResNet-50's distinct K1 [rows, C] shapes at batch 32 (224x224 input),
#: then one ragged shape (stage 3 at batch 1: rows = 49).
SHAPES = ((401408, 64), (100352, 64), (100352, 256), (25088, 128),
          (25088, 512), (6272, 256), (6272, 1024), (1568, 512),
          (1568, 2048), (49, 2048))
REQUESTS = (1, 3, 7, 32)
BUCKETS = (1, 2, 4, 8, 16, 32)
LAUNCHES_PER_FORWARD = 53
#: card output vs the port's CPU plain path: both float32 with TF32 off;
#: cuDNN and the CPU sum each convolution in other orders, over 53 convs
CPU_REL_TOL = 1e-3
#: server answer vs net.output on the same card: the same float32 values
#: through JSON (exact round trip), at most another bucket's algorithms
SERVER_REL_TOL = 1e-5
#: K2's dscale/dshift against the plain version, per channel, relative to
#: the sum over rows of |term|: float32 sums of up to 401,408 terms in two
#: different orders (either order's rounding error stays below about
#: 2e-5 of that sum)
K2_SUM_TOL = 1e-4
#: K1/K2 cases beyond the paths' shapes: C that is no multiple of a
#: 16-byte vector (the kernels take k-row periods of whole vectors) at row
#: counts with ragged ends, in float32, bfloat16 and float16; and shapes
#: also run with x (and dy) a view one element off 16-byte alignment (the
#: elementwise path)
K12_ODD_COLS = (3, 20, 50, 77, 1000)
K12_ODD_ROWS = (1, 7, 49, 4097)
K12_MISALIGNED = ((4097, 50), (49, 2048), (100352, 64))
TRAIN_STEPS = 12
TRAIN_BATCH = 32
PARITY_BATCH = 4
#: card vs the port's CPU plain path, one batch-4 training step from the
#: same weights, TF32 off: the loss within 1e-4 relative and every new BN
#: running statistic within 1e-3 relative as a whole-tensor norm (cuDNN
#: and the CPU sum each convolution in other orders, over 53 layers).
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
#: The parameter gradients of this net are ill-conditioned in float32: on
#: the CPU, float32 and float64 runs of the same code differ by about 2%
#: (whole-tensor, median over the parameters) and two float32 runs with
#: other thread counts by up to 1.8%. So each card gradient is held
#: against the CPU's float64 gradient: its error there must be within
#: 1e-3, or within GRAD_NOISE_FACTOR times the CPU float32 gradient's own
#: error there (the card is as accurate as float32 on the CPU allows).
GRAD_NOISE_FACTOR = 2.0
#: K3's shapes (B, H, Tq, Tk, d): BERT-base at batch 32 and 1, a ragged
#: length, a wider head, and cross attention (Tq != Tk)
ATTN_SHAPES = ((32, 12, 128, 128, 64), (1, 12, 128, 128, 64),
               (2, 12, 77, 77, 64), (2, 4, 200, 200, 128),
               (3, 2, 16, 24, 32))
#: K3 against its plain version: float32 outputs within 2e-5 absolute (the
#: JAX package's kernel-vs-reference contract is ~1e-5; the sums run in
#: another order and expf may differ by an ulp); m within 2e-5 of
#: max(1, |m|), l within 2e-5 relative. A 16-bit output within 2 ulps of
#: its dtype (kernels.flash_attention.ulp_error): p and o are rounded at
#: the same points in both, so only a rounding that f32 sum-order noise
#: flips can differ.
ATTN_F32_TOL = 2e-5
ATTN_ULP_TOL = 2.0
#: K3's operand layouts: packed [B, H, T, d], and the head split of a
#: [B, T, H*d] projection (rows H*d apart), which is what the BERT path
#: hands K3 and the layout that is timed
ATTN_LAYOUTS = ("packed", "heads")
#: the fused backward (K4 + K5) against its plain versions: float32 dq, dk
#: and dv within 2e-5 of max(1, |ref|) (sums of up to 300 terms of O(1) in
#: another order; expf may differ from PyTorch's exp by an ulp); 16-bit
#: within ATTN_ULP_TOL ulps (ds and p are rounded at the same points in
#: both)
ATTN_BWD_F32_TOL = 2e-5
#: backward shapes beyond K3's: Tk = 300 spans three key blocks of the
#: fused kernel at d = 32, so dq is summed from per-block partials; head
#: dimensions 48 and 96 leave the kernel's padded columns empty
ATTN_BWD_EXTRA_SHAPES = ((2, 4, 96, 300, 32), (2, 3, 50, 70, 48),
                         (1, 2, 33, 150, 96))
#: the NCHW epilogue check: LeNet's first convolution (5x5 to 20 channels
#: of 1 x 28 x 28 digits, ReLU), then batch norm and ReLU, at batch 64.
#: The output against the CPU plain path within NCHW_REL_TOL of max |ref|
#: (float32, TF32 off; cuDNN and the CPU sum the convolution in other
#: orders); the gradients by the training gates' rule (TRAIN_GRAD_TOL,
#: GRAD_NOISE_FACTOR) against a CPU float64 copy, since cuDNN may take a
#: transform-based algorithm for the weight gradient
NCHW_BATCH = 64
NCHW_REL_TOL = 1e-4
#: LeNet on synthetic MNIST through MultiLayerNetwork.fit: the JAX
#: package's synthetic tier (tests/test_lenet_mnist.py: batch 125, 8000
#: training and 2000 test digits, 3 epochs, accuracy >= 0.95); the card's
#: first steps against the port's CPU plain path from the same weights,
#: each loss within LENET_LOSS_TOL relative (float32, TF32 off; cuDNN and
#: the CPU sum the convolutions in other orders)
LENET_BATCH = 125
LENET_TRAIN = 8000
LENET_TEST = 2000
LENET_TEST_BATCH = 500
LENET_EPOCHS = 3
LENET_MIN_ACCURACY = 0.95
LENET_PARITY_STEPS = 3
LENET_LOSS_TOL = 1e-3
#: every parameter's gradient of the first batch, card against the CPU
#: plain path, whole-leaf relative error: float32, TF32 off, the
#: convolutions summed in other orders; measured at most 6.5e-07 (conv 1's
#: W) on an H100, so a few times that
LENET_GRAD_TOL = 5e-6
LENET_SEED = 123
#: K1 and K2 launches per LeNet step: its two convolutions' bias_act
LENET_CONVS = 2
#: [train]'s evaluate: the batch [train] fitted and EVAL_BATCHES - 1 fresh
#: batches of TRAIN_BATCH random images through the trained net; each card
#: prediction must be the CPU plain path's (same weights) unless the CPU's
#: top-2 gap is below EVAL_TIE_GAP (float32 sums in other orders can swap
#: a near tie)
EVAL_BATCHES = 3
EVAL_TIE_GAP = 1e-5
#: [transfer]: the trained ResNet-50 frozen through the end of its third
#: stage and re-headed with a 10-class OutputLayer on avgpool, fine-tuned
#: with DL4J's transfer-learning examples' updater, Nesterovs(5e-5,
#: momentum 0.9), for TRANSFER_STEPS batch-32 fit steps; the first
#: TRANSFER_PARITY_STEPS losses within TRANSFER_LOSS_TOL relative of the
#: CPU plain path's (the LeNet gate: float32, TF32 off, the convolutions
#: summed in other orders)
TRANSFER_FROZEN_TO = "s2_b5_out"
TRANSFER_CLASSES = 10
TRANSFER_STEPS = 10
TRANSFER_PARITY_STEPS = 3
TRANSFER_LOSS_TOL = 1e-3
#: [transfer]'s gradient gate reads the float64 rule over the first
#: TRANSFER_GRAD_BATCHES batches' gradients together (at the built net's
#: weights): the stage-4 BN leaves' float32 errors are ill-conditioned,
#: and one batch's worst card/allowed ratio moved with [train]'s weights,
#: which its fit does not repeat bit for bit (PERF.md, PR 16)
TRANSFER_GRAD_BATCHES = 3
#: [lenet-center]: LeNet re-headed with CenterLossOutputLayer(n_out=10) at
#: its defaults, fed by AsyncDataSetIterator(device_prefetch=True); the
#: first CENTER_PREFETCH_CHECK batches it yields must be plain iteration's
#: bit for bit, the centers after step 1 within CENTER_TOL (max |diff| /
#: max |ref|) of the CPU's
CENTER_PREFETCH_CHECK = 3
CENTER_TOL = 1e-5
BERT_REQUESTS = (1, 8, 32)
BERT_SEQ = 128
BERT_LAYERS = 12
FIT_BATCH = 32
FIT_STEPS = 12
FIT_PARITY_BATCH = 2
#: card vs the port's CPU plain path, one batch-2 fine-tune step from the
#: same weights, TF32 off: the loss within 1e-4 relative; each VARIABLE's
#: gradient against the CPU float64 gradient within max(TRAIN_GRAD_TOL,
#: GRAD_NOISE_FACTOR x the CPU float32 gradient's own error), PR 4's rule
FIT_LOSS_TOL = 1e-4
#: the card's last_hidden_state against the port's plain path on the CPU,
#: max |diff| / max |ref|: both float32 with TF32 off; cuBLAS, the CPU and
#: K3 sum in other orders over 12 layers
BERT_REL_TOL = 1e-4
#: K8's shapes (B, F, U): TextGenerationLSTM's two layers at batch 32 and
#: at batch 8 (the streams, and the bucket-8 request), one stream, a ragged
#: shape, and one batch above the reference's 8 MB VMEM budget
#: (``fits_vmem``), where the JAX package would leave the kernel
LSTM_SHAPES = ((32, 77, 256), (32, 256, 256), (8, 77, 256), (8, 256, 256),
               (1, 77, 256), (3, 50, 100), (512, 512, 512))
LSTM_PATH_SHAPES = ((32, 77, 256), (32, 256, 256))
LSTM_FORGET_BIAS = 1.0
#: the serving requests' 200 characters pad to this time bucket
LSTM_T_BUCKET = 256
#: the streamed outputs against output() on their concatenation, the same
#: weights on the same card: K8 runs the same steps; the output layer's
#: matmul may take another cuBLAS algorithm for another row count
LSTM_STREAM_TOL = 1e-6
#: the card's batch-2 output against the port's plain path on the CPU,
#: max |diff| / max |ref|: float32 with TF32 off, 256 steps of two layers
#: with sums in other orders
LSTM_REL_TOL = 1e-4
#: K9's shapes (B, H, C, d): the generative path's, a longer cache at
#: batch 32, BERT-base heads at two cache lengths, a 128-wide head, a
#: ragged one, and BERT-base heads at a cache of one split; the first is
#: the path's and the fourth the long one timed. Their split counts are
#: 2, 5, 2, 2, 8 (the cluster cap), 4 and 1
DECODE_SHAPES = ((8, 4, 128, 64), (32, 4, 1024, 64), (32, 12, 512, 64),
                 (32, 12, 4096, 64), (4, 8, 2048, 128), (3, 2, 200, 32),
                 (32, 12, 64, 64))
DECODE_PATH_SHAPE = DECODE_SHAPES[0]
DECODE_LONG_SHAPE = DECODE_SHAPES[3]
#: K10's shapes (B, H, k, C, d): the speculative mix's verify window (8
#: slots, cache 128), the speculative growth mix's at its largest cache,
#: BERT-base heads at a long cache, windows of 2 and 8 at one shape, a
#: cache length that is not a power of two, and BERT-base heads at a cache
#: of one split; the first three are timed. Their split counts are 2, 5,
#: 2, 8 (the cluster cap), 8, 4 and 1
MQ_SHAPES = ((8, 4, 4, 128, 64), (32, 4, 4, 1024, 64), (32, 12, 4, 4096, 64),
             (8, 4, 2, 512, 64), (8, 4, 8, 512, 64), (3, 2, 4, 200, 32),
             (32, 12, 4, 64, 64))
MQ_PATH_SHAPE, MQ_GROW_SHAPE, MQ_LONG_SHAPE = MQ_TIMED = MQ_SHAPES[:3]
#: K9 launches per decode step of the generative model (three attention
#: layers), K10 launches per verify step, and K3 launches per prefill
GEN_LAYERS = 3
#: the card's batch-2 output and each stream's last-step probabilities
#: against the port's plain path on the CPU, max |diff| / max |ref|:
#: float32 with TF32 off, sums in other orders over three blocks
GEN_REL_TOL = 1e-4
#: streams of the growth mix held against the CPU, and new tokens per
#: request of the server phase
GROW_CHECKED = 4
SERVER_NEW = 16
#: [disagg]'s mixed load (bench.py:2396-2399): interactive streams of
#: 8-token prompts x 16 new tokens beside long prompts of 112 tokens x 2
#: new tokens, cache 128 and pages of 16 rows (the port's paged mixes), in
#: interleaved rounds; fresh prompts from this seed
DISAGG_SHORT, DISAGG_LONG = 6, 6
DISAGG_PLEN_SHORT, DISAGG_PLEN_LONG = 8, 112
DISAGG_NEW_SHORT, DISAGG_NEW_LONG = 16, 2
DISAGG_CACHE, DISAGG_PAGE = 128, 16
DISAGG_ROUNDS = 3
DISAGG_SEED = 7
#: [disagg]'s router round: the growth mix's prompts x 64 new tokens over
#: two decode replicas of 16 slots and 640 pages (+ the zero page) each
ROUTER_NEW = 64
ROUTER_SLOTS = 16
ROUTER_PAGES = 641
#: [sd-decode]: tests/test_generative_decode.py's mini transformer stacked
#: 12 times at BERT-base's attention shape (H 12, d 64); B ragged prompts
#: of [low, high) tokens, cache 256, 32 decode steps, pages of 16 rows and
#: a verify window of 4 rows; each output within 1e-4 (max |diff| / max
#: |ref|) of the base graph over the full prefix, as the JAX test holds
#: its steps (float32, TF32 off)
SDD_BLOCKS, SDD_H, SDD_D = 12, 12, 64
SDD_B, SDD_PLEN, SDD_CACHE = 8, (100, 129), 256
SDD_STEPS, SDD_PAGE, SDD_WINDOW = 32, 16, 4
SDD_REL_TOL = 1e-4
SDD_SEED = 21
#: K6/K7's shapes [rows, C]: BERT-base's LayerNorm at batch 32, 2 and 1
#: (x 128 tokens), a ragged row count, a wider row, the widest the row
#: layout takes in 4 warps, and a tiny ragged one; the first is the path's
#: and is timed
LN_SHAPES = ((4096, 768), (256, 768), (128, 768), (77, 768), (4096, 1024),
             (33, 4096), (5, 37))
LN_PATH_SHAPE = LN_SHAPES[0]
#: BERT's LayerNorm epsilon, and K6 launches per fused BERT-base forward
#: (the embeddings', then two per layer)
LN_EPS = 1e-12
LN_SITES = 2 * BERT_LAYERS + 1
#: the 12 exact-GELU bias_act sites of a fused forward: [B*T, intermediate]
LN_GELU_SHAPE = (4096, 3072)
#: TextGenerationLSTM through MultiLayerNetwork.fit: the serving phase's
#: net with DL4J's zoo truncated-BPTT window (tools/profile_lstm.py build
#: with tbptt=TBPTT, 50), fit steps of batch 32 x 200 characters of an
#: order-2 Markov text (profile_lstm.markov_text) from this seed
LSTM_FIT_SEED = 0
#: the first batch's gradients, card against the CPU float64 gradient:
#: within max(TRAIN_GRAD_TOL, GRAD_NOISE_FACTOR x the CPU float32
#: gradient's own error) leaf by leaf (phase 7's rule); and against the
#: CPU's full-BPTT gradient at least LSTM_FIT_TRUNC_FACTOR times that
#: allowance away on every recurrent leaf (the truncation happened on the
#: card; on this net the truncated and the full gradients differ by 0.3 or
#: more of a recurrent leaf's norm)
LSTM_FIT_TRUNC_FACTOR = 100.0
#: the first LSTM_FIT_PARITY_STEPS losses, card against the CPU plain path
#: from the same weights, relative; the last loss at most this share of
#: the first (a CPU run of the 30 steps: 4.384 down to 3.526)
LSTM_FIT_PARITY_STEPS = 3
LSTM_FIT_LOSS_TOL = 1e-3
LSTM_FIT_FALL = 0.9
#: the trained net's batch-32 output() on the card against the CPU plain
#: path on the same weights, max |diff| / max |ref|
LSTM_FIT_OUT_TOL = 1e-4
#: [rnn-breadth]: every new recurrent-family layer at a small size, one
#: forward and one backward on the card against the CPU plain run on the
#: same weights: the output and every gradient within BREADTH_TOL of max
#: |ref| (float32, TF32 off, sums in other orders over a few steps)
BREADTH_TOL = 1e-5
BREADTH_B, BREADTH_T, BREADTH_F, BREADTH_U = 4, 12, 16, 32


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 25, warm: int = 3):
    """(device ms, host ms) of one call of ``fn``: the median over ``reps``
    calls of the CUDA-event time around each, and the host's mean enqueue
    time per call. A sleep kernel holds the stream while the calls are
    queued, so the events bracket the device's work alone and not the
    host's launch overhead."""
    for _ in range(warm):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # some 50 ms at the H100's clocks
    t0 = time.perf_counter()
    for a, b in ev:
        a.record()
        fn()
        b.record()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev), host


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def tree_max_rel(a: dict, b: dict):
    """(max relative error, its key) over two trees of tensors keyed by
    vertex, then by name."""
    worst = (0.0, "")
    for v, leaves in b.items():
        for k, want in leaves.items():
            e = rel_err(a[v][k].detach().cpu().numpy(),
                        want.detach().cpu().numpy())
            if e >= worst[0]:
                worst = (e, f"{v}/{k}")
    return worst


def phase_toolchain(build) -> None:
    log(f"[toolchain] {smi_line()}")
    log(f"[toolchain] python {sys.version.split()[0]} torch {torch.__version__}"
        f" cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    out = subprocess.run([build.nvcc(), "--version"], check=True,
                         capture_output=True, text=True, timeout=60).stdout
    log(f"[toolchain] nvcc {out.strip().splitlines()[-1]}")


def phase_build(build) -> None:
    t0 = time.perf_counter()
    logs = build.build_all()
    for name, text in logs.items():
        regs = [int(w) for line in text.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt.startswith("registers")]
        spills = sum("0 bytes spill stores" not in line
                     for line in text.splitlines() if "spill stores" in line)
        log(f"[build] {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
            f"registers, {spills} with spills")
    log(f"[build] {sorted(build.sources())} built in "
        f"{time.perf_counter() - t0:.1f} s")


def lenet_epilogue_calls(models, batch: int):
    """The (rows, C, act) of each K1 (and K2) call of a LeNet step at
    ``batch``: each convolution's [C, H, W] output as channels-last rows,
    from the configuration's own shape inference. LeNet's ``bias_act`` has
    no scale."""
    from deeplearning4j_tpu_torch.nn.config import _infer_shape
    from deeplearning4j_tpu_torch.nn.layers.conv import ConvolutionLayer
    conf = models.lenet_config()
    shape, calls = conf.input_shape, []
    for layer in conf.layers:
        shape = _infer_shape(layer, shape)
        if isinstance(layer, ConvolutionLayer):
            c, h, w = shape
            calls.append((batch * h * w, c, layer.activation))
    return calls


def lenet_step_calls(phase: dict) -> dict:
    """A kernel's float32 times summed over the calls of one LeNet step
    (batch 125), from [kernel] or [kernel-bwd]."""
    t = phase["lenet_times"].values()
    return {"ms": sum(v[0] for v in t), "plain_ms": sum(v[1] for v in t),
            "bound_ms": sum(v[2] for v in t),
            "shapes": [list(k) for k in phase["lenet_times"]]}


def check_k1_case(k1, x, s, shift, act, where, max_err) -> None:
    """K1 twice (bitwise equal) against its plain version, element by
    element; folds the error into ``max_err``."""
    y = k1.affine_act(x, s, shift, act)
    again = k1.affine_act(x, s, shift, act)
    torch.cuda.synchronize()
    if not torch.equal(y, again):
        raise AssertionError(f"{where} is not deterministic")
    ref = k1.affine_act_reference(x, s, shift, act)
    atol, rtol = k1.ulp_tolerance(x.dtype)
    err = (y.float() - ref.float()).abs()
    bad = err > atol + rtol * ref.float().abs()
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(
            f"{where} disagrees with its plain version at flat index {i}: "
            f"{float(y.flatten()[i])} vs {float(ref.flatten()[i])}")
    max_err[x.dtype] = max(max_err[x.dtype], float(err.max()))


def k12_odd_cases(k1, gen, check) -> int:
    """``check(x, scale, shift, dy, act, where)`` at K12_ODD_COLS x
    K12_ODD_ROWS x 3 dtypes x 7 activations x (scale, none), and at
    K12_MISALIGNED x 3 dtypes x (relu, geluexact) with x and dy views one
    element off 16-byte alignment; returns the count."""
    dev = torch.device("cuda")
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    cases = 0
    for cols in K12_ODD_COLS:
        for rows in K12_ODD_ROWS:
            for dtype in dtypes:
                x, dy = (torch.randn(rows, cols, generator=gen,
                                     device=dev).to(dtype) for _ in range(2))
                scale = torch.rand(cols, generator=gen, device=dev) + 0.5
                shift = torch.randn(cols, generator=gen, device=dev)
                for act in k1.ACTS:
                    for s in (scale, None):
                        check(x, s, shift, dy, act,
                              f"{act} {dtype} ({rows}, {cols}) "
                              f"scale={s is not None}")
                        cases += 1
    for rows, cols in K12_MISALIGNED:
        for dtype in dtypes:
            x, dy = (torch.randn(rows * cols + 1, generator=gen,
                                 device=dev).to(dtype)[1:].view(rows, cols)
                     for _ in range(2))
            assert x.data_ptr() % 16 and dy.data_ptr() % 16
            scale = torch.rand(cols, generator=gen, device=dev) + 0.5
            shift = torch.randn(cols, generator=gen, device=dev)
            for act in ("relu", "geluexact"):
                check(x, scale, shift, dy, act,
                      f"{act} {dtype} ({rows}, {cols}) x one element off "
                      f"16-byte alignment")
                cases += 1
            del x, dy
    return cases


def phase_kernel(k1, lenet_calls) -> dict:
    """K1 against its plain version, twice per case for determinism, at
    ResNet-50's shapes and at LeNet's (``lenet_calls``), with and without
    scale (a BN passes one; LeNet's and the Keras ResNet-50's conv biases
    do not); returns the
    per-(rows, C, act) float32 times {(rows, cols, act): (ms, plain_ms,
    library_ms, host_ms)}, LeNet's path calls' {(rows, cols, act): (ms,
    plain_ms, bound_ms)} and errors."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    times, lenet_times = {}, {}
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0, torch.float16: 0.0}
    cases = 0
    shapes = [(r, c, None) for r, c in SHAPES] + list(lenet_calls)
    for rows, cols, path_act in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(rows, cols, generator=gen, device=dev).to(dtype)
            scale = torch.rand(cols, generator=gen, device=dev) + 0.5
            shift = torch.randn(cols, generator=gen, device=dev)
            for act in k1.ACTS:
                for s in (scale, None):
                    check_k1_case(k1, x, s, shift, act,
                                  f"K1 {act} {dtype} ({rows}, {cols}) "
                                  f"scale={s is not None}", max_err)
                    cases += 1
            itemsize = x.element_size()
            if path_act is not None:
                # LeNet's own call: no scale, its activation
                ms, host = time_ms(
                    lambda: k1.affine_act(x, None, shift, path_act))
                plain, _ = time_ms(lambda: k1.affine_act_reference(
                    x, None, shift, path_act))
                bound = 1e3 * max(
                    k1.bytes_moved(rows, cols, itemsize, False)
                    / k1.H100_BYTES_PER_S,
                    k1.flops(rows, cols, path_act, False)
                    / k1.H100_F32_FLOPS_PER_S)
                if dtype == torch.float32:
                    lenet_times[(rows, cols, path_act)] = (ms, plain, bound)
                log(f"[kernel] K1 {str(dtype)[6:]:8s} act={path_act:8s} "
                    f"rows={rows:6d} C={cols:4d} no scale (LeNet) "
                    f"ms={ms:.5f} plain_ms={plain:.5f} bound_ms={bound:.5f}"
                    f" host_ms={host:.5f}")
                del x
                continue
            bound = k1.bound_ms(rows, cols, itemsize, "relu")
            for act in ("identity", "relu"):
                ms, host = time_ms(
                    lambda: k1.affine_act(x, scale, shift, act))
                plain, _ = time_ms(
                    lambda: k1.affine_act_reference(x, scale, shift, act))
                # one PyTorch call computing the same function: the affine
                # in float32 (no activation folded, no bfloat16 output)
                lib = time_ms(lambda: torch.addcmul(shift, x, scale))[0] \
                    if act == "identity" and dtype == torch.float32 else None
                if dtype == torch.float32:
                    times[(rows, cols, act)] = (ms, plain, lib, host)
                log(f"[kernel] K1 {str(dtype)[6:]:8s} act={act:8s} "
                    f"rows={rows:6d} C={cols:4d} ms={ms:.5f} "
                    f"plain_ms={plain:.5f} bound_ms={bound:.5f} "
                    f"library_ms={'null' if lib is None else f'{lib:.5f}'} "
                    f"host_ms={host:.5f}")
            del x
    odd = k12_odd_cases(k1, gen, lambda x, s, b, dy, act, where:
                        check_k1_case(k1, x, s, b, act, "K1 " + where,
                                      max_err))
    log(f"[kernel] K1 matches its plain version and repeats bit for bit: "
        f"{cases} cases ((10 ResNet-50 shapes + LeNet's "
        f"{len(lenet_calls)}) x 7 activations x (float32, bfloat16) x (with, "
        f"without scale)) and {odd} at odd C and misaligned x; max abs err "
        f"float32 "
        f"{max_err[torch.float32]:.3g}, bfloat16 "
        f"{max_err[torch.bfloat16]:.3g}, float16 "
        f"{max_err[torch.float16]:.3g}")
    occ = {str(dt)[6:]: k1.occupancy(dt, "relu")
           for dt in (torch.float32, torch.bfloat16)}
    log(f"[kernel] K1 relu with scale, registers / CTAs an SM: "
        + ", ".join(f"{k} {v['registers']} / {v['ctas_per_sm']}"
                    for k, v in occ.items()))
    return {"times": times, "lenet_times": lenet_times, "max_err": max_err,
            "occupancy": occ}


def k1_path_calls(net, batch: int):
    """The (rows, C, act) of every K1 launch in one folded forward of
    ``net`` at ``batch``: one per BatchNormalization vertex."""
    from deeplearning4j_tpu_torch.nn.layers.conv import BatchNormalization
    from deeplearning4j_tpu_torch.nn.vertices import LayerVertex
    fold, _ = net._epilogue_fold_plan()
    calls = []
    for name in net._topo:
        v, _ = net._vertex_map[name]
        if isinstance(v, LayerVertex) and \
                isinstance(v.layer, BatchNormalization):
            h, w, c = net._shapes[name]
            calls.append((batch * h * w, c, fold.get(name, "identity")))
    return calls


def phase_serve(k1, fe, env, models, graph) -> dict:
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    net = models.resnet50(seed=0).init(device="cuda")
    log(f"[serve] resnet50 init on cuda: {net.num_params()} params, "
        f"{time.perf_counter() - t0:.1f} s")
    calls = k1_path_calls(net, 1)
    if len(calls) != LAUNCHES_PER_FORWARD:
        raise AssertionError(f"{len(calls)} BN vertices, expected "
                             f"{LAUNCHES_PER_FORWARD}")
    eng = net.inference_engine()
    t0 = time.perf_counter()
    eng.warmup(BUCKETS)
    log(f"[serve] warmup {list(BUCKETS)}: {time.perf_counter() - t0:.1f} s")

    # ---- the serving path: counts from 0, read after the server phase ----
    k1.launches = 0
    k1.bwd_launches = 0
    fe.reset_counters()
    forwards = 0
    rng = np.random.default_rng(0)
    latency = {}
    for n in REQUESTS:
        x = rng.standard_normal((n, 224, 224, 3), dtype=np.float32)
        ts = []
        for _ in range(5):
            before = k1.launches
            t0 = time.perf_counter()
            y = net.output(x)
            ts.append((time.perf_counter() - t0) * 1e3)
            forwards += 1
            got = k1.launches - before
            if got != LAUNCHES_PER_FORWARD:
                raise AssertionError(f"request of {n}: {got} K1 launches, "
                                     f"expected {LAUNCHES_PER_FORWARD}")
        if y.shape != (n, 1000) or not np.isfinite(y).all() or \
                not np.allclose(y.sum(axis=1), 1.0, atol=1e-4):
            raise AssertionError(f"request of {n}: bad output {y.shape}")
        latency[n] = statistics.median(ts)
        log(f"[serve] request of {n:2d} images (bucket "
            f"{1 << (n - 1).bit_length()}): median {latency[n]:.3f} ms "
            f"over 5, {n * 1e3 / latency[n]:.1f} images/s, "
            f"{LAUNCHES_PER_FORWARD} K1 launches each")

    # the card against the port's plain path on the CPU, same weights
    cpu = graph.ComputationGraph(net.conf).init(device="cpu")
    cpu.params = {v: {k: t.cpu() for k, t in p.items()}
                  for v, p in net.params.items()}
    cpu.state = {v: {k: t.cpu() for k, t in p.items()}
                 for v, p in net.state.items()}
    x2 = rng.standard_normal((2, 224, 224, 3), dtype=np.float32)
    out_gpu = net.output(x2)
    pool_gpu = net.feed_forward(x2)["avgpool"].cpu().numpy()
    forwards += 2
    out_cpu = cpu.output(x2)
    pool_cpu = cpu.feed_forward(x2)["avgpool"].numpy()
    e_out, e_pool = rel_err(out_gpu, out_cpu), rel_err(pool_gpu, pool_cpu)
    log(f"[serve] card vs CPU plain path, batch 2: output rel err "
        f"{e_out:.3g}, avgpool rel err {e_pool:.3g} (tolerance "
        f"{CPU_REL_TOL})")
    if not (e_out <= CPU_REL_TOL and e_pool <= CPU_REL_TOL):
        raise AssertionError("the card disagrees with the CPU plain path")
    if k1.launches != forwards * LAUNCHES_PER_FORWARD:
        raise AssertionError(f"{k1.launches} K1 launches for {forwards} "
                             "forwards")
    return {"net": net, "forwards": forwards, "calls": calls,
            "latency_ms": latency, "rel_err": (e_out, e_pool)}


def phase_server(k1, server_mod, net) -> int:
    rng = np.random.default_rng(1)
    forwards = 0
    with server_mod.JsonModelServer(net, device="cuda", max_batch_size=32,
                                    max_wait_ms=2.0) as srv:
        url = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            if json.loads(r.read())["status"] != "ok":
                raise AssertionError("GET /health")
        for n in (1, 2, 1, 2):
            x = rng.standard_normal((n, 224, 224, 3), dtype=np.float32)
            body = json.dumps({"data": x.tolist()}).encode()
            req = urllib.request.Request(
                url + "/predict", data=body,
                headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                got = np.asarray(json.loads(r.read())["output"], np.float32)
            dt = (time.perf_counter() - t0) * 1e3
            want = net.output(x)
            forwards += 1
            e = rel_err(got, want)
            log(f"[server] POST /predict {n} image(s): {dt:.1f} ms "
                f"(JSON included), rel err vs net.output {e:.3g}")
            if got.shape != want.shape or e > SERVER_REL_TOL:
                raise AssertionError("server answer disagrees")
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            st = json.loads(r.read())
        forwards += st["batches"]
        log(f"[server] stats: {st['requests']} requests in {st['batches']} "
            f"batches, p50 {st['latency_ms_p50']:.1f} ms")
    return forwards


def check_k2_case(k1, x, s, shift, dy, act, where, err) -> None:
    """K2 twice (bitwise equal) against its plain version: dx element by
    element, dscale and dshift per channel against the column's sum of
    |term| (K2_SUM_TOL); folds the errors into ``err``."""
    got = k1.affine_act_bwd(x, s, shift, dy, act)
    again = k1.affine_act_bwd(x, s, shift, dy, act)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        if a is not None and not torch.equal(a, b):
            raise AssertionError(f"{where} is not deterministic")
    want = k1.affine_act_bwd_reference(x, s, shift, dy, act)
    atol, rtol = k1.ulp_tolerance(x.dtype)
    e = (got[0].float() - want[0].float()).abs()
    if bool((e > atol + rtol * want[0].float().abs()).any()):
        raise AssertionError(f"{where}: dx disagrees, max abs err "
                             f"{float(e.max())}")
    key = "dx_" + str(x.dtype)[6:]
    err[key] = max(err[key], float(e.max()))
    # per-channel sums of |term|: the scale of each sum
    xf = x.float()
    z = xf * s + shift if s is not None else xf + shift
    dz = (dy.float() * k1.act_grad(act, z)).abs()
    scales = [dz.sum(0)] + ([] if s is None else [(dz * xf.abs()).sum(0)])
    pairs = [(got[2], want[2])] + ([] if s is None else [(got[1], want[1])])
    for (g, w), mag in zip(pairs, scales):
        d = (g - w).abs()
        if bool((d > K2_SUM_TOL * mag + 1e-6).any()):
            raise AssertionError(f"{where}: a column sum disagrees, max abs "
                                 f"err {float(d.max())}")
        err["dscale_dshift"] = max(err["dscale_dshift"], float(d.max()))
        err["dscale_dshift_rel"] = max(err["dscale_dshift_rel"],
                                       float((d / (mag + 1e-30)).max()))


def phase_kernel_bwd(k1, lenet_calls) -> dict:
    """K2 against its plain version, twice per case for determinism, at
    ResNet-50's shapes and LeNet's (``lenet_calls``), with and without
    scale; returns float32 times {(rows, cols, act): (ms, plain_ms,
    host_ms)}, LeNet's path calls' {(rows, cols, act): (ms, plain_ms,
    bound_ms)} and errors."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    times, lenet_times = {}, {}
    err = {"dx_float32": 0.0, "dx_bfloat16": 0.0, "dx_float16": 0.0,
           "dscale_dshift": 0.0, "dscale_dshift_rel": 0.0}
    cases = 0
    shapes = [(r, c, None) for r, c in SHAPES] + list(lenet_calls)
    for rows, cols, path_act in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(rows, cols, generator=gen, device=dev).to(dtype)
            dy = torch.randn(rows, cols, generator=gen, device=dev).to(dtype)
            scale = torch.rand(cols, generator=gen, device=dev) + 0.5
            shift = torch.randn(cols, generator=gen, device=dev)
            for act in k1.ACTS:
                for s in (scale, None):
                    check_k2_case(k1, x, s, shift, dy, act,
                                  f"K2 {act} {dtype} ({rows}, {cols}) "
                                  f"scale={s is not None}", err)
                    cases += 1
            itemsize = x.element_size()
            if path_act is not None:
                # LeNet's own call: no scale, its activation
                bound = k1.bound_ms_bwd(rows, cols, itemsize, path_act,
                                        has_scale=False)
                ms, host = time_ms(lambda: k1.affine_act_bwd(
                    x, None, shift, dy, path_act))
                plain, _ = time_ms(lambda: k1.affine_act_bwd_reference(
                    x, None, shift, dy, path_act))
                if dtype == torch.float32:
                    lenet_times[(rows, cols, path_act)] = (ms, plain, bound)
                log(f"[kernel-bwd] K2 {str(dtype)[6:]:8s} act={path_act:8s} "
                    f"rows={rows:6d} C={cols:4d} no scale (LeNet) "
                    f"ms={ms:.5f} plain_ms={plain:.5f} bound_ms={bound:.5f}"
                    f" host_ms={host:.5f}")
                del x, dy
                continue
            for act in ("identity", "relu"):
                bound = k1.bound_ms_bwd(rows, cols, itemsize, act)
                ms, host = time_ms(
                    lambda: k1.affine_act_bwd(x, scale, shift, dy, act))
                plain, _ = time_ms(
                    lambda: k1.affine_act_bwd_reference(x, scale, shift, dy,
                                                        act))
                if dtype == torch.float32:
                    times[(rows, cols, act)] = (ms, plain, host)
                log(f"[kernel-bwd] K2 {str(dtype)[6:]:8s} act={act:8s} "
                    f"rows={rows:6d} C={cols:4d} ms={ms:.5f} "
                    f"plain_ms={plain:.5f} bound_ms={bound:.5f} "
                    f"library_ms=null host_ms={host:.5f}")
            del x, dy
    odd = k12_odd_cases(k1, gen, lambda x, s, b, dy, act, where:
                        check_k2_case(k1, x, s, b, dy, act, "K2 " + where,
                                      err))
    log(f"[kernel-bwd] K2 matches its plain version and repeats bit for "
        f"bit: {cases} cases (10 ResNet-50 and {len(lenet_calls)} LeNet "
        f"shapes x 7 activations x (float32, bfloat16) x (scale, no "
        f"scale)) and {odd} at odd C and misaligned x; max abs err dx "
        f"float32 {err['dx_float32']:.3g}, bfloat16 "
        f"{err['dx_bfloat16']:.3g}, float16 {err['dx_float16']:.3g}; "
        f"dscale/dshift {err['dscale_dshift']:.3g} (at most "
        f"{err['dscale_dshift_rel']:.3g} of the column's sum of |term|, "
        f"tolerance {K2_SUM_TOL})")
    shapes = [(r, c) for r, c in SHAPES] + [(r, c) for r, c, _ in lenet_calls]
    per_call = one_kernel_a_call("K2", shapes, "affine_act_bwd_kernel")
    log(f"[kernel-bwd] kernels one K2 call launches (torch.profiler, a fresh "
        f"process, {len(shapes)} shapes x 3 dtypes), by CTA count: "
        f"{per_call}")
    occ = {str(dt)[6:]: k1.occupancy(dt, "relu", backward=True)
           for dt in (torch.float32, torch.bfloat16)}
    log(f"[kernel-bwd] K2 relu with scale, registers / CTAs an SM: "
        + ", ".join(f"{k} {v['registers']} / {v['ctas_per_sm']}"
                    for k, v in occ.items()))
    return {"times": times, "lenet_times": lenet_times, "max_err": err,
            "per_call": per_call, "occupancy": occ}


def _batch(rng, n):
    x = rng.standard_normal((n, 224, 224, 3), dtype=np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, n)]
    return x, y


def phase_train(k1, fe, env, models, graph) -> dict:
    from deeplearning4j_tpu_torch.tools.profile_serving import device_us
    env.Environment.instance().f32_matmul_precision = "highest"
    rng = np.random.default_rng(2)
    net = models.resnet50(seed=0).init(device="cuda")

    # ---- parity: one batch-4 step on the card vs the CPU plain path ----
    def cpu_copy(dtype, cast):
        conf = graph.ComputationGraphConfiguration.from_json(json.dumps(
            {**json.loads(net.conf.to_json()), "dtype": dtype}))
        m = graph.ComputationGraph(conf).init(device="cpu")
        m.params = {v: {k: cast(t.cpu()) for k, t in p.items()}
                    for v, p in net.params.items()}
        m.state = {v: {k: cast(t.cpu()) for k, t in p.items()}
                   for v, p in net.state.items()}
        return m

    x4, y4 = _batch(rng, PARITY_BATCH)

    def loss_grads(m):
        with env.precision(m.device):
            return m._value_and_grad((m._tensor(x4),), (m._tensor(y4),),
                                     (None,), (None,))

    t0 = time.perf_counter()
    loss_g, grads_g, bn_g = loss_grads(net)
    torch.cuda.synchronize()
    loss_c, grads_c, bn_c = loss_grads(cpu_copy("FLOAT", lambda t: t))
    _, grads_64, _ = loss_grads(cpu_copy("DOUBLE", lambda t: t.double()))
    e_loss = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    e_bn, at_bn = tree_max_rel(bn_g, bn_c)
    e_grad, at_grad = tree_max_rel(grads_g, grads_c)
    worst, bad = (0.0, "", 0.0, 0.0), []
    for v, leaves in grads_64.items():
        for k, g64 in leaves.items():
            want = g64.numpy()
            e_card = rel_err(grads_g[v][k].cpu().numpy(), want)
            e_cpu = rel_err(grads_c[v][k].numpy(), want)
            allowed = max(TRAIN_GRAD_TOL, GRAD_NOISE_FACTOR * e_cpu)
            if e_card / allowed >= worst[0]:
                worst = (e_card / allowed, f"{v}/{k}", e_card, e_cpu)
            if e_card > allowed:
                bad.append(f"{v}/{k}")
    log(f"[train] card vs CPU plain path, one batch-{PARITY_BATCH} step "
        f"({time.perf_counter() - t0:.1f} s): loss {float(loss_g):.6f} vs "
        f"{float(loss_c):.6f} (rel err {e_loss:.3g}, tolerance "
        f"{TRAIN_LOSS_TOL}); max BN running-stat rel err {e_bn:.3g} at "
        f"{at_bn} (tolerance {TRAIN_GRAD_TOL}); max gradient rel err card "
        f"vs CPU float32 {e_grad:.3g} at {at_grad}; against the CPU "
        f"float64 gradient the worst card/allowed ratio is {worst[0]:.3g} "
        f"at {worst[1]} (card {worst[2]:.3g}, CPU float32 {worst[3]:.3g}; "
        f"allowed max({TRAIN_GRAD_TOL}, {GRAD_NOISE_FACTOR} x CPU float32)); "
        f"{len(grads_c)} vertices with parameters")
    if not (e_loss <= TRAIN_LOSS_TOL and e_bn <= TRAIN_GRAD_TOL) or bad:
        raise AssertionError(f"training on the card disagrees with the CPU "
                             f"plain path (gradients out of bounds: {bad})")
    del grads_g, grads_c, bn_g, bn_c

    # ---- the main path: counts from 0, read after the last fit ----
    x, y = _batch(rng, TRAIN_BATCH)
    k1.launches = 0
    k1.bwd_launches = 0
    fe.reset_counters()
    steps = 0

    def step():
        nonlocal steps
        before = (k1.launches, k1.bwd_launches)
        net.fit(x, y)
        steps += 1
        got = (k1.launches - before[0], k1.bwd_launches - before[1])
        if got != (LAUNCHES_PER_FORWARD, LAUNCHES_PER_FORWARD):
            raise AssertionError(f"training step {steps}: {got} K1/K2 "
                                 f"launches, expected "
                                 f"{LAUNCHES_PER_FORWARD} each")

    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(net.score())
    log(f"[train] fit, batch {TRAIN_BATCH}, {TRAIN_STEPS} steps: losses "
        + " ".join(f"{v:.4f}" for v in losses))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training loss not finite and falling: "
                             f"{losses}")
    median = statistics.median(step_ms[1:])

    # device split of three steps (after one profiled step that pays the
    # tracer's start-up)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        step()
    reps = 3
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and device_us(e) > 0]
    dev_ms = sum(device_us(e) for e in kernels) / 1e3 / reps
    k2_ms = sum(device_us(e) for e in kernels
                if "affine_act_bwd" in e.key) / 1e3 / reps
    k1_ms = sum(device_us(e) for e in kernels
                if "affine_act_kernel" in e.key) / 1e3 / reps
    top = sorted(kernels, key=device_us, reverse=True)[:6]

    launches = (k1.launches, k1.bwd_launches)
    copies, decisions = fe.dy_copies, fe.counters()
    sentinel = net.resilience_counters()
    if launches != (steps * LAUNCHES_PER_FORWARD,) * 2:
        raise AssertionError(f"main path: {launches} K1/K2 launches for "
                             f"{steps} training steps")
    if decisions["fused"] != launches[0] or decisions["fallback_act"] \
            or sentinel["bad_total"]:
        raise AssertionError(f"training decisions {decisions}, sentinel "
                             f"{sentinel}")
    log(f"[train] step {median:.3f} ms median of {TRAIN_STEPS - 1} "
        f"({TRAIN_BATCH * 1e3 / median:.1f} images/s); device "
        f"{dev_ms:.3f} ms per step (busy share {dev_ms / median:.3f}), K1 "
        f"{k1_ms:.3f} ms + K2 {k2_ms:.3f} ms; {LAUNCHES_PER_FORWARD} K1 + "
        f"{LAUNCHES_PER_FORWARD} K2 launches in each of {steps} steps; "
        f"{copies / steps:.2f} dy copies per step; sentinel {sentinel}")
    log("[train] top kernels (ms per step): " + "; ".join(
        f"{e.key[:60]} {device_us(e) / 1e3 / reps:.3f} x{e.count // reps}"
        for e in top))
    return {"net": net, "batch": (x, y), "fit_batch": (x, y),
            "parity_batch": (x4, y4), "grads_64": grads_64, "steps": steps,
            "launches": launches,
            "losses": losses, "step_ms": median, "device_ms": dev_ms,
            "k1_ms": k1_ms, "k2_ms": k2_ms, "dy_copies": copies / steps,
            "parity": (e_loss, e_grad, e_bn)}


def phase_nchw(k1, fe, env) -> dict:
    """Channels-first conv + ReLU + BN + ReLU on the card: K1 and K2 take the
    channels-last view of NCHW activations (two K1 launches forward, two K2
    backward, one counted copy: the convolution's NCHW output), and the
    output and every gradient match the CPU plain path."""
    from deeplearning4j_tpu_torch.tools.nchw_block import nchw_block
    env.Environment.instance().f32_matmul_precision = "highest"
    gen = torch.Generator().manual_seed(9)
    params = {"W": torch.randn(20, 1, 5, 5, generator=gen) * 0.2,
              "b": torch.randn(20, generator=gen),
              "gamma": torch.rand(20, generator=gen) + 0.5,
              "beta": torch.randn(20, generator=gen)}
    x = torch.rand(NCHW_BATCH, 1, 28, 28, generator=gen)
    with env.precision("cuda"):
        nchw_block(x, params, "cuda")  # warm-up: cuDNN's algorithm choice
        torch.cuda.synchronize()
        fe.reset_counters()
        before = (k1.launches, k1.bwd_launches)
        z, grads = nchw_block(x, params, "cuda")
        torch.cuda.synchronize()
        launches = (k1.launches - before[0], k1.bwd_launches - before[1])
    decisions, copies = fe.counters(), fe.nchw_copies
    want_z, want = nchw_block(x, params, "cpu")
    _, want64 = nchw_block(x.double(), {k: v.double()
                                        for k, v in params.items()}, "cpu")
    worst = max((rel_err(grads[k].cpu().numpy(), g64.numpy())
                 / max(TRAIN_GRAD_TOL, GRAD_NOISE_FACTOR
                       * rel_err(want[k].numpy(), g64.numpy())), k)
                for k, g64 in want64.items())
    out_rel = float((z.cpu() - want_z).abs().max() / want_z.abs().max())
    log(f"[nchw] conv 20x5x5 + ReLU + BN + ReLU on {NCHW_BATCH} x 1 x 28 x 28 "
        f"NCHW: K1/K2 launches {launches}, decisions {decisions}, "
        f"channels-last copies {copies}; card vs CPU plain path: out "
        f"{out_rel:.3g} of max |ref| (tolerance {NCHW_REL_TOL}); against the "
        f"CPU float64 gradients the worst card/allowed ratio is "
        f"{worst[0]:.3g} ({worst[1]}; allowed max({TRAIN_GRAD_TOL}, "
        f"{GRAD_NOISE_FACTOR} x CPU float32))")
    if launches != (2, 2) or decisions["fused"] != 2 or copies != 1 \
            or any(v for k, v in decisions.items() if k != "fused"):
        raise AssertionError(f"NCHW block: K1/K2 launches {launches}, "
                             f"decisions {decisions}, copies {copies}")
    if out_rel > NCHW_REL_TOL or worst[0] > 1.0:
        raise AssertionError("the NCHW block on the card disagrees with the "
                             "CPU plain path")
    return {"launches": launches, "rel_err": out_rel,
            "worst_grad_share": worst[0]}


def phase_lenet(k1, fe, env, models) -> dict:
    """LeNet (zoo ``lenet()``, full width, NCHW, Adam(1e-3), l2(5e-5),
    float32, TF32 off) trained through ``MultiLayerNetwork.fit`` on
    synthetic MNIST: the card's first steps against the CPU plain path
    from the same weights; then 3 epochs of batch 125 with the launch
    counts set to 0 just before and read just after (2 K1 + 2 K2 a step,
    one channels-last copy a step, only ``fused`` decisions); the test
    accuracy; step time, images/s and a ``torch.profiler`` split."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.mnist import MnistDataSetIterator
    from deeplearning4j_tpu_torch.tools.profile_serving import device_us
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    train = MnistDataSetIterator(LENET_BATCH, num_examples=LENET_TRAIN)
    test = MnistDataSetIterator(LENET_TEST_BATCH, train=False,
                                num_examples=LENET_TEST)
    render_s = time.perf_counter() - t0

    # ---- parity: the first steps on the card vs the CPU plain path ----
    first = [DataSet(d.features, d.labels)
             for _, d in zip(range(LENET_PARITY_STEPS), train)]
    train.reset()
    card = models.lenet(seed=LENET_SEED)
    cpu = models.lenet(seed=LENET_SEED, device="cpu")
    cpu.params = {k: {n: t.detach().cpu().clone() for n, t in p.items()}
                  for k, p in card.params.items()}
    # every parameter's gradient of the first batch, leaf by leaf
    x0, y0 = first[0].features, first[0].labels
    g_card = card._value_and_grad(card._tensor(x0), card._tensor(y0))[1]
    g_cpu = cpu._value_and_grad(cpu._tensor(x0), cpu._tensor(y0))[1]
    torch.cuda.synchronize()
    grad_err = tree_max_rel(g_card, g_cpu)
    log(f"[lenet] card vs CPU plain path, every parameter's gradient of the "
        f"first batch: worst whole-leaf rel err {grad_err[0]:.3g} "
        f"({grad_err[1]}; tolerance {LENET_GRAD_TOL}); per leaf "
        + ", ".join(
            f"{v}/{k} {rel_err(g_card[v][k].cpu().numpy(), g.numpy()):.3g}"
            for v, leaves in g_cpu.items() for k, g in leaves.items()))
    if grad_err[0] > LENET_GRAD_TOL:
        raise AssertionError(f"LeNet gradient {grad_err[1]} on the card "
                             "disagrees with the CPU plain path")
    del g_card, g_cpu
    per_step, losses = [], []
    for ds in first:
        before = (k1.launches, k1.bwd_launches)
        fe.reset_counters()
        card.fit(ds)
        torch.cuda.synchronize()
        per_step.append((k1.launches - before[0],
                         k1.bwd_launches - before[1], fe.nchw_copies,
                         dict(fe.counters())))
        cpu.fit(ds)
        losses.append((card.score(), cpu.score()))
    loss_err = max(abs(a - b) / abs(b) for a, b in losses)
    log(f"[lenet] card vs CPU plain path, the first {LENET_PARITY_STEPS} "
        f"batch-{LENET_BATCH} steps from the same weights: losses "
        + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in losses)
        + f" (worst rel err {loss_err:.3g}, tolerance {LENET_LOSS_TOL}); "
        f"K1, K2, channels-last copies a step: "
        f"{[p[:3] for p in per_step]}")
    if loss_err > LENET_LOSS_TOL:
        raise AssertionError("LeNet training on the card disagrees with the "
                             "CPU plain path")
    for k1n, k2n, copies, decisions in per_step:
        if (k1n, k2n, copies) != (LENET_CONVS, LENET_CONVS, 1) or any(
                v for k, v in decisions.items() if k != "fused"):
            raise AssertionError(f"LeNet step: K1/K2 {k1n}/{k2n}, copies "
                                 f"{copies}, decisions {decisions}")
    del card, cpu

    # ---- the main path: counts from 0, read after the last epoch ----
    net = models.lenet(seed=LENET_SEED)
    k1.launches = 0
    k1.bwd_launches = 0
    fe.reset_counters()
    epoch_ms = []
    for _ in range(LENET_EPOCHS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        net.fit(train)
        torch.cuda.synchronize()
        epoch_ms.append((time.perf_counter() - t1) * 1e3)
    launches = (k1.launches, k1.bwd_launches)
    copies, decisions = fe.nchw_copies, dict(fe.counters())
    steps = net.iteration
    loss = net.score()
    sentinel = net.resilience_counters()
    if steps != LENET_EPOCHS * -(-LENET_TRAIN // LENET_BATCH) or \
            launches != (LENET_CONVS * steps,) * 2 or copies != steps or \
            decisions["fused"] != LENET_CONVS * steps or any(
                v for k, v in decisions.items() if k != "fused") or \
            sentinel["bad_total"] or not np.isfinite(loss):
        raise AssertionError(f"LeNet fit: {steps} steps, K1/K2 {launches}, "
                             f"copies {copies}, decisions {decisions}, "
                             f"sentinel {sentinel}, loss {loss}")

    # ---- evaluation: one forward (2 K1) a test batch ----
    k1.launches = 0
    k1.bwd_launches = 0
    ev = net.evaluate(test)
    eval_launches = (k1.launches, k1.bwd_launches)
    forwards = -(-LENET_TEST // LENET_TEST_BATCH)
    acc = ev.accuracy()
    if eval_launches != (LENET_CONVS * forwards, 0):
        raise AssertionError(f"LeNet evaluate: K1/K2 {eval_launches} for "
                             f"{forwards} forwards")

    # ---- device split of 5 steps (after one that starts the tracer) ----
    batches = [DataSet(d.features, d.labels)
               for _, d in zip(range(6), train)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        net.fit(batches[0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for ds in batches[1:]:
            net.fit(ds)
        torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t1) * 1e3 / (len(batches) - 1)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and device_us(e) > 0]
    reps = len(batches) - 1
    dev_ms = sum(device_us(e) for e in kernels) / 1e3 / reps
    k1_ms = sum(device_us(e) for e in kernels
                if "affine_act_kernel" in e.key) / 1e3 / reps
    k2_ms = sum(device_us(e) for e in kernels
                if "affine_act_bwd" in e.key) / 1e3 / reps
    top = sorted(kernels, key=device_us, reverse=True)[:6]
    per_epoch = steps // LENET_EPOCHS
    step_ms = statistics.median(epoch_ms) / per_epoch
    log(f"[lenet] fit: {LENET_EPOCHS} epochs x {per_epoch} steps of batch "
        f"{LENET_BATCH} on {train.source} MNIST ({LENET_TRAIN} digits, "
        f"rendered in {render_s:.1f} s): epochs "
        + " ".join(f"{v:.1f}" for v in epoch_ms)
        + f" ms, {step_ms:.4f} ms a step ({LENET_BATCH * 1e3 / step_ms:.1f}"
        f" images/s), last loss {loss:.4f}; K1/K2 launches {launches} "
        f"({LENET_CONVS} + {LENET_CONVS} a step), channels-last copies "
        f"{copies}, decisions {decisions}, sentinel {sentinel}")
    log(f"[lenet] evaluate on {LENET_TEST} test digits: accuracy {acc:.4f} "
        f"(at least {LENET_MIN_ACCURACY}), {eval_launches[0]} K1 launches "
        f"for {forwards} forwards")
    # the busy share is the profiled device time over the unprofiled step
    # (the tracer slows the host's side of a step down twofold)
    log(f"[lenet] profiled steps: device {dev_ms:.4f} ms a step (busy share "
        f"{dev_ms / step_ms:.3f} of the unprofiled {step_ms:.4f} ms step; "
        f"{dev_ms / prof_ms:.3f} of the {prof_ms:.4f} ms profiled step), K1 "
        f"{k1_ms:.4f} ms + K2 {k2_ms:.4f} ms; top kernels (ms a step): "
        + "; ".join(f"{e.key[:50]} {device_us(e) / 1e3 / reps:.4f} "
                    f"x{e.count // reps}" for e in top))
    log(f"[lenet] {smi_line()}")
    if acc < LENET_MIN_ACCURACY:
        raise AssertionError(f"LeNet synthetic-MNIST accuracy {acc:.4f} < "
                             f"{LENET_MIN_ACCURACY}")
    return {"launches": launches, "eval_launches": eval_launches,
            "steps": steps, "accuracy": acc, "step_ms": step_ms,
            "images_per_s": LENET_BATCH * 1e3 / step_ms,
            "device_ms": dev_ms, "busy_share": dev_ms / step_ms,
            "profiled_step_ms": prof_ms, "grad_rel_err": grad_err[0],
            "k1_ms": k1_ms, "k2_ms": k2_ms, "loss_rel_err": loss_err,
            "source": train.source, "train": train, "test": test}


def cpu_twin(graph, net, dtype="FLOAT", cast=lambda t: t):
    """A ComputationGraph on the CPU with ``net``'s configuration (its
    ``dtype`` replaced), parameters and state (through ``cast``), and a
    fresh updater state: the plain path the card is held against."""
    conf = graph.ComputationGraphConfiguration.from_json(json.dumps(
        {**json.loads(net.conf.to_json()), "dtype": dtype}))
    m = graph.ComputationGraph(conf).init(device="cpu")
    m.params = {v: {k: cast(t.detach().cpu()) for k, t in p.items()}
                for v, p in net.params.items()}
    m.state = {v: {k: cast(t.detach().cpu()) for k, t in p.items()}
               for v, p in net.state.items()}
    m.updater_state = conf.updater.init_state(m.params)
    return m


def check_predictions(card_out, cpu_out, where) -> int:
    """The card's class predictions against the CPU's: every disagreement
    must sit where the CPU's top-2 gap is below EVAL_TIE_GAP. Returns the
    number of excused ties."""
    top2 = np.sort(cpu_out, axis=1)[:, -2:]
    differ = card_out.argmax(1) != cpu_out.argmax(1)
    near = (top2[:, 1] - top2[:, 0]) < EVAL_TIE_GAP
    if (differ & ~near).any():
        raise AssertionError(f"{where}: {int((differ & ~near).sum())} card "
                             "predictions differ from the CPU plain path's")
    return int((differ & near).sum())


def check_confusion(card, cpu, labels, cpu_out, where) -> int:
    """The card's confusion matrix against the CPU plain path's (rows the
    true class, columns the predicted; ``labels`` and ``cpu_out`` the
    evaluated rows in order): they may differ only where a CPU near-tie
    (top-2 gap below EVAL_TIE_GAP) moves its count from the CPU's top-1
    column to its top-2 column in its true class's row, at most one count
    a near-tie. Returns the number of counts moved."""
    n = max(card.shape[0], cpu.shape[0], cpu_out.shape[1])
    diff = np.zeros((n, n), np.int64)
    diff[:card.shape[0], :card.shape[1]] += card
    diff[:cpu.shape[0], :cpu.shape[1]] -= cpu
    order = np.argsort(cpu_out, axis=1)
    top = np.take_along_axis(cpu_out, order[:, -2:], axis=1)
    near = (top[:, 1] - top[:, 0]) < EVAL_TIE_GAP
    rows = labels.argmax(1)[near]
    may = np.zeros((n, n), bool)
    may[rows, order[near, -1]] = True
    may[rows, order[near, -2]] = True
    moved = int(diff[diff > 0].sum())
    if diff[~may].any() or diff.sum(1).any() or moved > int(near.sum()):
        raise AssertionError(f"{where}: the card's confusion matrix is not "
                             "the CPU plain path's up to its near-ties")
    return moved


def phase_train_eval(k1, fe, graph, net, fitted) -> dict:
    """[train]'s ``evaluate``: the trained ResNet-50 through
    ``ComputationGraph.evaluate`` over EVAL_BATCHES batch-32 batches (the
    one it was fitted on first; 53 K1 launches a forward, no K2), its
    Evaluation against the CPU plain path's on the same weights and
    batches."""
    from deeplearning4j_tpu_torch.data.dataset import (DataSet,
                                                       ListDataSetIterator)
    from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
    rng = np.random.default_rng(4)
    batches = [DataSet(*fitted)] + [DataSet(*_batch(rng, TRAIN_BATCH))
                                    for _ in range(EVAL_BATCHES - 1)]
    k1.launches = 0
    k1.bwd_launches = 0
    fe.reset_counters()
    t0 = time.perf_counter()
    ev = net.evaluate(ListDataSetIterator(batches))
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    launches = (k1.launches, k1.bwd_launches)
    decisions = dict(fe.counters())
    if launches != (EVAL_BATCHES * LAUNCHES_PER_FORWARD, 0) or \
            decisions["fused"] != launches[0] or \
            any(v for k, v in decisions.items() if k != "fused"):
        raise AssertionError(f"[train] evaluate: K1/K2 {launches} for "
                             f"{EVAL_BATCHES} forwards, decisions "
                             f"{decisions}")
    cpu = cpu_twin(graph, net)
    ev_cpu, cpu_outs, ties = Evaluation(), [], 0
    for b in batches:  # cpu.evaluate's loop, keeping the CPU outputs
        out = cpu.output(b.features)
        ev_cpu.eval(b.labels, out)
        cpu_outs.append(out)
        ties += check_predictions(net.output(b.features), out,
                                  "[train] evaluate")
    moved = check_confusion(ev.confusion, ev_cpu.confusion,
                            np.concatenate([b.labels for b in batches]),
                            np.concatenate(cpu_outs), "[train] evaluate")
    n = EVAL_BATCHES * TRAIN_BATCH
    log(f"[train] evaluate on {EVAL_BATCHES} batches of {TRAIN_BATCH}: "
        f"accuracy {ev.accuracy():.4f} (CPU plain path {ev_cpu.accuracy():.4f}"
        f"; confusion matrices differ by {moved} of {n} counts, each a CPU "
        f"near-tie's; {ties} excused near-ties in a second output), "
        f"{launches[0]} K1 launches ({LAUNCHES_PER_FORWARD} a forward), "
        f"{eval_ms:.1f} ms")
    return {"launches": launches, "accuracy": ev.accuracy(),
            "accuracy_cpu": ev_cpu.accuracy(), "ties": ties, "moved": moved}


def transfer_graph(net):
    """[transfer]'s net: the trained ResNet-50 ``net`` through
    ``TransferLearning.GraphBuilder``, frozen through TRANSFER_FROZEN_TO
    (the end of its third stage), ``fc`` removed, a new
    TRANSFER_CLASSES-way OutputLayer on ``avgpool``, fine-tuned with
    Nesterovs(5e-5, momentum 0.9)."""
    from deeplearning4j_tpu_torch.nn.layers.core import OutputLayer
    from deeplearning4j_tpu_torch.nn.transfer import (FineTuneConfiguration,
                                                      TransferLearning)
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs
    return (TransferLearning.GraphBuilder(net)
            .fine_tune_configuration(FineTuneConfiguration(
                updater=Nesterovs(learning_rate=5e-5, momentum=0.9)))
            .set_feature_extractor(TRANSFER_FROZEN_TO)
            .remove_vertex("fc")
            .add_layer("out", OutputLayer(n_out=TRANSFER_CLASSES),
                       "avgpool")
            .set_outputs("out").build())


def transfer_batches(n: int = 4) -> list:
    """[transfer]'s ``n`` batch-32 DataSets (random images, 10 classes)."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    rng = np.random.default_rng(5)
    y_of = np.eye(TRANSFER_CLASSES, dtype=np.float32)
    return [DataSet(rng.standard_normal((TRAIN_BATCH, 224, 224, 3),
                                        dtype=np.float32),
                    y_of[rng.integers(0, TRANSFER_CLASSES, TRAIN_BATCH)])
            for _ in range(n)]


def graph_loss_grads(env, m, x, y):
    """``(loss, grads)`` of one training forward and backward of the
    one-input graph ``m`` on ``(x, y)``, nothing updated."""
    with env.precision(m.device):
        loss, grads, _ = m._value_and_grad((m._tensor(x),), (m._tensor(y),),
                                           (None,), (None,))
    return loss, grads


def grad_ratios(g_card, g_cpu, g_64, frozen, zero_factor=None) -> list:
    """The float64 rule leaf by leaf over the vertices outside ``frozen``,
    ``g_card``, ``g_cpu`` and ``g_64`` each a list of gradient trees, one
    per batch: ``(card error / allowed, leaf, card error, CPU float32
    error)``, worst first, each error the relative norm of the leaf's
    gradients over all the batches together against the CPU float64 ones,
    allowed max(TRAIN_GRAD_TOL, GRAD_NOISE_FACTOR x the CPU float32
    error); with ``zero_factor``, a leaf whose CPU float32 error is 1 or
    more (its float64 gradient is zero up to rounding) is allowed
    ``zero_factor`` x that error. Raises if a frozen vertex has a
    gradient."""
    def cat(trees, v, k):
        return np.concatenate([t[v][k].detach().cpu().numpy().ravel()
                               for t in trees])

    rows = []
    for v, leaves in g_64[0].items():
        if v in frozen:
            if any(t.any() for g in g_card for t in g[v].values()):
                raise AssertionError(f"frozen vertex {v} has a gradient")
            continue
        for k in leaves:
            want = cat(g_64, v, k)
            e_card = rel_err(cat(g_card, v, k), want)
            e_cpu = rel_err(cat(g_cpu, v, k), want)
            allowed = zero_factor * e_cpu \
                if zero_factor is not None and e_cpu >= 1.0 else \
                max(TRAIN_GRAD_TOL, GRAD_NOISE_FACTOR * e_cpu)
            rows.append((e_card / allowed, f"{v}/{k}", e_card, e_cpu))
    return sorted(rows, reverse=True)


def phase_transfer(k1, fe, env, graph, net) -> dict:
    """[transfer]: the trained ResNet-50 (full width) through
    ``TransferLearning.GraphBuilder``: frozen through ``s2_b5_out`` (the
    end of its third stage), ``fc`` removed, a new 10-class OutputLayer on
    ``avgpool``; then TRANSFER_STEPS batch-32 ``fit`` steps and
    ``evaluate``. Gates: every frozen parameter and frozen BN running
    statistic bit-identical after ``fit``; the gradients of the trainable
    leaves on the first TRANSFER_GRAD_BATCHES batches together within the
    float64 rule of [train]; the first losses within TRANSFER_LOSS_TOL of
    the CPU;
    only ``fused`` decisions; the K1 and K2 launches the fold plan
    implies (every BN vertex runs K1 in a forward, a frozen one with the
    identity act and its ReLU apart; only the trainable BNs run K2)."""
    from deeplearning4j_tpu_torch.data.dataset import ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.layers.conv import BatchNormalization
    from deeplearning4j_tpu_torch.tools.profile_serving import device_us
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    new = transfer_graph(net)
    build_s = time.perf_counter() - t0

    # ---- the launches the fold plan implies ----
    fold, skip = new._epilogue_fold_plan()
    bns = [n for n, v, _ in new.conf.vertices
           if isinstance(getattr(v, "layer", None), BatchNormalization)
           or isinstance(getattr(getattr(v, "layer", None), "layer", None),
                         BatchNormalization)]
    k1_fwd = len(bns)
    k2_step = sum(n not in new._frozen for n in bns)
    frozen_bn = [n for n in bns if n in new._frozen]
    if any(n in fold for n in frozen_bn):
        raise AssertionError("a frozen BN was folded")
    log(f"[transfer] built in {build_s:.1f} s: {len(new._frozen)} frozen "
        f"vertices ({len(frozen_bn)} of {len(bns)} BNs), fold plan folds "
        f"{len(fold)} ({sorted(fold)}); so {k1_fwd} K1 a forward and "
        f"{k2_step} K2 a step")
    if (k1_fwd, k2_step) != (LAUNCHES_PER_FORWARD, 10):
        raise AssertionError(f"fold plan implies {k1_fwd} K1 / {k2_step} K2,"
                             " predicted 53 / 10")

    batches = transfer_batches()
    frozen_p = {v: {k: t.clone() for k, t in new.params[v].items()}
                for v in new._frozen if v in new.params}
    frozen_s = {v: {k: t.clone() for k, t in new.state[v].items()}
                for v in new._frozen if v in new.state}

    # ---- the first batches' gradients: card vs the CPU float64 rule ----
    cpu = cpu_twin(graph, new)
    twins = (new, cpu, cpu_twin(graph, new, "DOUBLE", lambda t: t.double()))
    first, grads = [], ([], [], [])
    for b in batches[:TRANSFER_GRAD_BATCHES]:
        for m, into in zip(twins, grads):
            loss, g = graph_loss_grads(env, m, b.features, b.labels)
            first.append(float(loss))
            into.append(g)
    log(f"[transfer] the first batch's loss: card {first[0]:.8f}, CPU "
        f"float32 {first[1]:.8f}, float64 {first[2]:.8f}")
    errs = grad_ratios(*grads, new._frozen)
    worst = errs[0]
    trainable = sum(v not in new._frozen for v in grads[2][0])
    log(f"[transfer] card vs CPU float64, the first "
        f"{TRANSFER_GRAD_BATCHES} batch-{TRAIN_BATCH} steps' gradients "
        f"together, of the {trainable} trainable vertices: worst "
        f"card/allowed {worst[0]:.3g} at {worst[1]} (allowed "
        f"max({TRAIN_GRAD_TOL}, {GRAD_NOISE_FACTOR} x CPU float32)); frozen "
        f"vertices' gradients zero; the worst five (card, CPU float32): "
        + ", ".join(f"{n} {a:.3g} {b:.3g}" for _, n, a, b in errs[:5]))
    bad = [n for r, n, _, _ in errs if r > 1]
    if bad:
        raise AssertionError(f"transfer gradients out of bounds: {bad}")
    del twins, grads

    # ---- the main path: counts from 0, read after the last step ----
    k1.launches = 0
    k1.bwd_launches = 0
    fe.reset_counters()
    losses, cpu_losses, step_ms, per_step = [], [], [], []
    for i in range(TRANSFER_STEPS):
        ds = batches[i % len(batches)]
        before = (k1.launches, k1.bwd_launches)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        new.fit(ds)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        per_step.append((k1.launches - before[0],
                         k1.bwd_launches - before[1]))
        losses.append(new.score())
    launches = (k1.launches, k1.bwd_launches)
    decisions = dict(fe.counters())
    t1 = time.perf_counter()
    for ds in batches[:TRANSFER_PARITY_STEPS]:
        cpu.fit(ds)
        cpu_losses.append(cpu.score())
    cpu_s = time.perf_counter() - t1
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    changed = [f"{v}/{k}" for v, p in frozen_p.items() for k, t in p.items()
               if not torch.equal(new.params[v][k], t)] + \
        [f"{v}/{k}" for v, p in frozen_s.items() for k, t in p.items()
         if not torch.equal(new.state[v][k], t)]
    moved = [v for v in new.state if v not in new._frozen
             and not torch.equal(new.state[v]["mean"],
                                 net.state[v]["mean"])]
    log(f"[transfer] fit {TRANSFER_STEPS} steps of batch {TRAIN_BATCH}: "
        f"losses " + " ".join(f"{v:.4f}" for v in losses)
        + f"; the first {TRANSFER_PARITY_STEPS} vs the CPU plain path "
        + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in zip(losses, cpu_losses))
        + f" (worst rel err {loss_err:.3g}, tolerance {TRANSFER_LOSS_TOL};"
        f" the CPU's steps {cpu_s:.1f} s); K1/K2 a step "
        f"{sorted(set(per_step))}; decisions {decisions}; "
        f"{sum(len(p) for p in frozen_p.values())} frozen parameters and "
        f"{sum(len(p) for p in frozen_s.values())} frozen running "
        f"statistics bit-identical: {not changed}; {len(moved)} trainable "
        f"BNs' statistics moved")
    if changed:
        raise AssertionError(f"frozen tensors moved in fit: {changed[:5]}")
    if loss_err > TRANSFER_LOSS_TOL or not all(np.isfinite(losses)):
        raise AssertionError("transfer training on the card disagrees with "
                             "the CPU plain path")
    if set(per_step) != {(k1_fwd, k2_step)} or \
            launches != (TRANSFER_STEPS * k1_fwd, TRANSFER_STEPS * k2_step) \
            or decisions["fused"] != launches[0] or any(
                v for k, v in decisions.items() if k != "fused"):
        raise AssertionError(f"transfer fit: K1/K2 {per_step}, decisions "
                             f"{decisions}")
    median = statistics.median(step_ms[1:])

    # ---- device split of 3 steps (after one that starts the tracer) ----
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        new.fit(batches[0])
    reps = 3
    with torch.profiler.profile(activities=acts) as prof:
        for ds in batches[1:1 + reps]:
            new.fit(ds)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and device_us(e) > 0]
    dev_ms = sum(device_us(e) for e in kernels) / 1e3 / reps

    # ---- evaluate: one forward (53 K1) a batch ----
    k1.launches = 0
    k1.bwd_launches = 0
    ev = new.evaluate(ListDataSetIterator(batches))
    eval_launches = (k1.launches, k1.bwd_launches)
    if eval_launches != (len(batches) * k1_fwd, 0):
        raise AssertionError(f"transfer evaluate: K1/K2 {eval_launches}")
    log(f"[transfer] step {median:.3f} ms median of {TRANSFER_STEPS - 1} "
        f"({TRAIN_BATCH * 1e3 / median:.1f} images/s); device {dev_ms:.3f} "
        f"ms a step (busy share {dev_ms / median:.3f}); evaluate on "
        f"{len(batches)} batches: accuracy {ev.accuracy():.4f}, "
        f"{eval_launches[0]} K1 launches")
    return {"launches": launches, "eval_launches": eval_launches,
            "k1_per_forward": k1_fwd, "k2_per_step": k2_step,
            "step_ms": median, "device_ms": dev_ms,
            "busy_share": dev_ms / median, "loss_rel_err": loss_err,
            "grad_worst_ratio": worst[0], "accuracy": ev.accuracy()}


def phase_lenet_center(k1, fe, env, models, train, test) -> dict:
    """[lenet-center]: zoo LeNet with its output layer swapped for
    ``CenterLossOutputLayer(n_out=10)`` at the layer's defaults (DL4J's
    CenterLoss LeNet example), 3 epochs of the synthetic MNIST through
    ``AsyncDataSetIterator(device_prefetch=True)``. Gates: the first
    batches the iterator yields are plain iteration's bit for bit; the
    first 3 losses within LENET_LOSS_TOL of the CPU plain path and the
    centers after step 1 within CENTER_TOL; 2 K1 + 2 K2 a step and only
    ``fused`` decisions; test accuracy at least LENET_MIN_ACCURACY."""
    import dataclasses
    from deeplearning4j_tpu_torch.data.dataset import (AsyncDataSetIterator,
                                                       DataSet)
    from deeplearning4j_tpu_torch.models.lenet import lenet_config
    from deeplearning4j_tpu_torch.nn.layers.special import \
        CenterLossOutputLayer
    from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
    env.Environment.instance().f32_matmul_precision = "highest"
    conf = lenet_config(seed=LENET_SEED)
    conf = dataclasses.replace(conf, layers=list(conf.layers[:-1]) + [
        CenterLossOutputLayer(n_out=10)])
    key = str(len(conf.layers) - 1)

    # ---- the prefetching iterator against plain iteration ----
    train.reset()
    plain = [DataSet(d.features, d.labels)
             for _, d in zip(range(CENTER_PREFETCH_CHECK), train)]
    train.reset()
    it = AsyncDataSetIterator(train, device_prefetch=True)
    got = [d for _, d in zip(range(CENTER_PREFETCH_CHECK), it)]
    same = all(g.features.is_cuda and torch.equal(
        g.features.cpu(), torch.from_numpy(p.features)) and torch.equal(
        g.labels.cpu(), torch.from_numpy(p.labels))
        for g, p in zip(got, plain))
    it.reset()
    if not same or len(got) != CENTER_PREFETCH_CHECK:
        raise AssertionError("AsyncDataSetIterator(device_prefetch=True) "
                             "does not yield plain iteration's batches")

    # ---- parity: the first steps on the card vs the CPU plain path ----
    card = MultiLayerNetwork(conf).init(device="cuda")
    cpu = MultiLayerNetwork(conf).init(device="cpu")
    cpu.params = {k: {n: t.detach().cpu().clone() for n, t in p.items()}
                  for k, p in card.params.items()}
    losses, center_err = [], None
    for i, (g, p) in enumerate(zip(got, plain)):
        card.fit(g)
        cpu.fit(p)
        losses.append((card.score(), cpu.score()))
        if i == 0:
            ref = cpu.state[key]["centers"]
            center_err = float((card.state[key]["centers"].cpu() - ref)
                               .abs().max() / ref.abs().max())
    loss_err = max(abs(a - b) / abs(b) for a, b in losses)
    log(f"[lenet-center] card vs CPU plain path, the first "
        f"{CENTER_PREFETCH_CHECK} batch-{LENET_BATCH} steps (prefetched on "
        f"the card, bit-identical to plain iteration): losses "
        + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in losses)
        + f" (worst rel err {loss_err:.3g}, tolerance {LENET_LOSS_TOL}); "
        f"centers after step 1 {center_err:.3g} of max |ref| (tolerance "
        f"{CENTER_TOL})")
    if loss_err > LENET_LOSS_TOL or center_err > CENTER_TOL:
        raise AssertionError("center-loss LeNet on the card disagrees with "
                             "the CPU plain path")
    del card, cpu

    # ---- the main path: counts from 0, read after the last epoch ----
    net = MultiLayerNetwork(conf).init(device="cuda")
    k1.launches = 0
    k1.bwd_launches = 0
    fe.reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(it, epochs=LENET_EPOCHS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = (k1.launches, k1.bwd_launches)
    decisions = dict(fe.counters())
    steps = net.iteration
    if steps != LENET_EPOCHS * -(-LENET_TRAIN // LENET_BATCH) or \
            launches != (LENET_CONVS * steps,) * 2 or \
            decisions["fused"] != LENET_CONVS * steps or any(
                v for k, v in decisions.items() if k != "fused") or \
            it.stats()["bad_records"]:
        raise AssertionError(f"center-loss LeNet fit: {steps} steps, K1/K2 "
                             f"{launches}, decisions {decisions}")
    acc = net.evaluate(test).accuracy()
    centers = net.state[key]["centers"]
    log(f"[lenet-center] fit: {LENET_EPOCHS} epochs x {steps // LENET_EPOCHS}"
        f" steps through AsyncDataSetIterator(device_prefetch=True) in "
        f"{fit_s:.2f} s ({fit_s * 1e3 / steps:.4f} ms a step), last loss "
        f"{net.score():.4f}; K1/K2 launches {launches} ({LENET_CONVS} + "
        f"{LENET_CONVS} a step), decisions {decisions}; centers' norms "
        f"{centers.norm(dim=1).min():.3f}..{centers.norm(dim=1).max():.3f}; "
        f"test accuracy {acc:.4f} (at least {LENET_MIN_ACCURACY})")
    if acc < LENET_MIN_ACCURACY:
        raise AssertionError(f"center-loss LeNet accuracy {acc:.4f} < "
                             f"{LENET_MIN_ACCURACY}")
    return {"launches": launches, "steps": steps, "accuracy": acc,
            "step_ms": fit_s * 1e3 / steps, "loss_rel_err": loss_err,
            "center_rel_err": center_err}


# ------------------------------------------------- the training modes
#: [train-bf16]: fit steps of the bfloat16 ResNet-50, and the bf16 band
#: of the JAX package against its f32 oracle (tests/test_mixed_precision.py)
BF16_STEPS = 10
BF16_RTOL = 7e-2
BF16_ATOL = 5e-2
#: The loss gate. The first BF16_REF_STEPS losses, where ResNet-50
#: memorizing one batch falls 7.66 -> 0.13 and bf16 runs a fraction of a
#: step behind float32 (past the JAX band of float32's at steps 3 and 4),
#: each within BF16_REF_SHARE of the band around the CPU plain path's bf16
#: loss from the same weights and batch (a deterministic reference; the
#: CPU takes ~12 s a bf16 step, so it runs only these); [train]'s float32
#: losses, what float32 compute under the bf16 configuration gives, must
#: leave that limit there. The later losses within the JAX band of
#: [train]'s float32 losses.
BF16_REF_STEPS = 4
BF16_REF_SHARE = 0.5
#: fused against unfused master-cast steps: steps a run, runs of each
#: route in alternation (the step times compared), and the factor over
#: the spread of two unfused runs when those do not repeat bit for bit
FUSED_STEPS = 3
FUSED_PAIRS = 3
SPREAD_FACTOR = 2.0
#: [train-accum]: microbatches a step, the accumulated step's batch
ACCUM_STEPS = 4
ACCUM_BATCH = 128
ACCUM_STEPS_RUN = 3
#: [remat]: the workspace modes held against "none"
REMAT_MODES = ("full", "every_4")
#: [remat]: the BN running statistics one ``fit`` step commits against
#: the new statistics of its loss's forward, relative to their largest
#: magnitude: the same forward gives them again (float32 sums in another
#: order at most), while a second commit would move them by another
#: (1 - decay) step, a tenth of the way to the batch moments
REMAT_BN_TOL = 1e-5
#: [lenet-on-device]: synchronizing calls allowed in one fit_on_device
#: call, none of them inside an epoch: the upload of the features and of
#: the labels, the loss history's one read at the end, and one spare
ON_DEVICE_MAX_SYNCS = 4
#: [lenet-solver]: LBFGS iterations a batch, batches, relative tolerance
#: of the first batch's per-iteration losses against the CPU plain path
SOLVER_ITERATIONS = 5
SOLVER_BATCHES = 4
SOLVER_LOSS_TOL = 1e-3


class TimedBatches:
    """``n`` passes of one batch as a DataSetIterator, the card
    synchronized and the clock read before each batch and after the last,
    and the step's loss (a device tensor) kept after each."""

    def __init__(self, net, x, y, n):
        from deeplearning4j_tpu_torch.data.dataset import DataSet
        self.net, self.ds, self.n = net, DataSet(x, y), n
        self.ticks, self.losses = [], []

    def __iter__(self):
        for i in range(self.n):
            torch.cuda.synchronize()
            self.ticks.append(time.perf_counter())
            yield self.ds
            self.losses.append(self.net._score)
        torch.cuda.synchronize()
        self.ticks.append(time.perf_counter())

    def step_ms(self):
        return [(b - a) * 1e3 for a, b in zip(self.ticks, self.ticks[1:])]


def as_iterator(it):
    from deeplearning4j_tpu_torch.data.dataset import DataSetIterator

    class _It(DataSetIterator):
        def __iter__(self):
            return iter(it)

        def batch_size(self):
            return it.ds.num_examples()
    return _It()


def flat(*trees) -> torch.Tensor:
    """Every leaf of the trees (a tensor is its own leaf) as one float64
    vector on the card."""
    return torch.cat([t.detach().reshape(-1).double().to("cuda")
                      for tree in trees for t in flat_leaves(tree)])


def spread_check_many(refs, c, where) -> dict:
    """The determinism rule: ``refs`` runs of the reference, ``c`` the
    candidate (flat vectors). When the references repeat bit for bit,
    ``c`` must equal them; else ``c``'s distance to the nearest must be
    within SPREAD_FACTOR times the largest distance between two of them
    (a further draw of the same noise lands there; a candidate that
    computes something else is far from all)."""
    d_ref = max(float((a - b).abs().max())
                for i, a in enumerate(refs) for b in refs[i + 1:])
    d_c = min(float((c - a).abs().max()) for a in refs)
    if d_ref == 0.0:
        ok, rule = d_c == 0.0, "bitwise"
    else:
        ok, rule = d_c <= SPREAD_FACTOR * d_ref, \
            f"within {SPREAD_FACTOR} x the spread"
    if not ok:
        raise AssertionError(f"{where}: candidate differs from the nearest "
                             f"reference run by {d_c:.3g}, the runs from "
                             f"each other by up to {d_ref:.3g} ({rule})")
    return {"rule": rule, "reference_spread": d_ref, "candidate_diff": d_c}


class Deterministic:
    """cuDNN's deterministic algorithms inside the block, restored after."""

    def __enter__(self):
        self.old = (torch.backends.cudnn.deterministic,
                    torch.backends.cudnn.benchmark,
                    torch.are_deterministic_algorithms_enabled(),
                    torch.is_deterministic_algorithms_warn_only_enabled())
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True, warn_only=True)
        return self

    def __exit__(self, *exc):
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = self.old[:2]
        torch.use_deterministic_algorithms(self.old[2],
                                           warn_only=self.old[3])


def clone_tree(tree):
    from deeplearning4j_tpu_torch.utils.tree import tmap
    return tmap(lambda t: t.detach().clone(), tree)


def flat_leaves(tree):
    from deeplearning4j_tpu_torch.utils.tree import leaves
    return list(leaves(tree))


def profile_step_split(step, reps: int = 2) -> tuple:
    """(device ms, K1 ms, K2 ms) per call of ``step`` from
    ``torch.profiler`` (one call first pays the tracer's start-up)."""
    from deeplearning4j_tpu_torch.tools.profile_serving import device_us
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        step()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and device_us(e) > 0]
    dev = sum(device_us(e) for e in kernels) / 1e3 / reps
    k2 = sum(device_us(e) for e in kernels
             if "affine_act_bwd" in e.key) / 1e3 / reps
    k1_ = sum(device_us(e) for e in kernels
              if "affine_act_kernel" in e.key) / 1e3 / reps
    return dev, k1_, k2


def bf16_path_times(k1, calls) -> dict:
    """bfloat16 K1 and K2 at the (rows, C, act) of one batch-32 ResNet-50
    forward and step: each distinct call held against its plain version
    (K2 element by element, twice for determinism) and timed by CUDA
    events, summed over the path's calls."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    err = {"dx_float32": 0.0, "dx_bfloat16": 0.0, "dscale_dshift": 0.0,
           "dscale_dshift_rel": 0.0}
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    per = {}
    for rows, cols, act in sorted(set(calls)):
        x = torch.randn(rows, cols, generator=gen, device=dev).to(
            torch.bfloat16)
        dy = torch.randn(rows, cols, generator=gen, device=dev).to(
            torch.bfloat16)
        scale = torch.rand(cols, generator=gen, device=dev) + 0.5
        shift = torch.randn(cols, generator=gen, device=dev)
        where = f"bf16 ({rows}, {cols}) {act}"
        check_k1_case(k1, x, scale, shift, act, "K1 " + where, max_err)
        check_k2_case(k1, x, scale, shift, dy, act, "K2 " + where, err)
        ms1 = time_ms(lambda: k1.affine_act(x, scale, shift, act))[0]
        ms2 = time_ms(lambda: k1.affine_act_bwd(x, scale, shift, dy, act))[0]
        per[(rows, cols, act)] = (ms1, ms2, k1.bound_ms(rows, cols, 2, act),
                                  k1.bound_ms_bwd(rows, cols, 2, act))
        del x, dy
    sums = [sum(per[c][i] for c in calls) for i in range(4)]
    return {"k1_ms": sums[0], "k2_ms": sums[1], "k1_bound_ms": sums[2],
            "k2_bound_ms": sums[3], "cases": len(per),
            "k1_max_err": max_err[torch.bfloat16],
            "k2_max_err": err["dx_bfloat16"],
            "k2_sum_rel": err["dscale_dshift_rel"]}


def band_shares(losses, ref) -> list:
    """Each loss's distance to ``ref``'s as a share of the JAX bf16 band
    (BF16_ATOL + BF16_RTOL x |ref|)."""
    return [abs(a - b) / (BF16_ATOL + BF16_RTOL * abs(b))
            for a, b in zip(losses, ref)]


def phase_train_bf16(k1, fe, env, models, graph, trained, f32_times) -> dict:
    """[train-bf16]: zoo ResNet-50 with ``data_type("BFLOAT16")``, full
    width, uncut, Adam(1e-3), from [train]'s initial weights (seed 0). No
    l1/l2 term, so ``fit`` takes the fused master-cast updater. Gates: f32
    masters, updater state and BN statistics; one ``fused_updater``
    decision; 53 bf16 K1 a forward and 53 bf16 K2 a step, ``fused`` only;
    the fused step against the unfused one over FUSED_STEPS steps (params
    and updater state, by the determinism rule; FUSED_PAIRS runs of each
    in alternation, their step times printed); the batch-4 gradients by
    [train]'s float64 rule with the CPU bf16 error in place of the
    float32 error; of BF16_STEPS losses on [train]'s batch, the first
    BF16_REF_STEPS each within BF16_REF_SHARE of the JAX band around the
    CPU plain path's bf16 loss ([train]'s float32 losses outside it), the
    rest within the JAX band of [train]'s float32 losses, the last below
    1% of the first."""
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    net = models.resnet50(seed=0, dtype="BFLOAT16").init(device="cuda")
    for name, tree in (("masters", net.params),
                       ("updater state", net.updater_state),
                       ("BN statistics", net.state)):
        bad = [t.dtype for t in flat_leaves(tree) if t.dtype != torch.float32]
        if bad:
            raise AssertionError(f"[train-bf16] {name} not float32: {bad[:3]}")
    init = (clone_tree(net.params), clone_tree(net.state),
            clone_tree(net.updater_state))
    twin = cpu_twin(graph, net, "BFLOAT16")

    # ---- the batch-4 gradients by the float64 rule ----
    x4, y4 = trained["parity_batch"]
    g_card = graph_loss_grads(env, net, x4, y4)[1]
    t1 = time.perf_counter()
    g_cpu = graph_loss_grads(env, twin, x4, y4)[1]
    cpu_s = time.perf_counter() - t1
    rows = grad_ratios([g_card], [g_cpu], [trained["grads_64"]], ())
    worst = rows[0]
    log(f"[train-bf16] batch-{PARITY_BATCH} gradients (CPU bf16 "
        f"{cpu_s:.1f} s): against the CPU float64 gradient the worst "
        f"card/allowed ratio is {worst[0]:.3g} at {worst[1]} (card "
        f"{worst[2]:.3g}, CPU bfloat16 {worst[3]:.3g}; allowed "
        f"max({TRAIN_GRAD_TOL}, {GRAD_NOISE_FACTOR} x CPU bfloat16))")
    if worst[0] > 1.0:
        raise AssertionError(f"[train-bf16] gradients out of bounds: "
                             f"{[r[1] for r in rows if r[0] > 1.0]}")
    del g_card, g_cpu

    # ---- the first losses' reference: the CPU plain path's bf16 fit ----
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    t1 = time.perf_counter()
    cpu_losses = []
    for _ in range(BF16_REF_STEPS - 1):
        twin.fit(*trained["fit_batch"])
        cpu_losses.append(twin.score())
    cpu_losses.append(twin.score(DataSet(*trained["fit_batch"])))
    cpu_fit_s = time.perf_counter() - t1
    del twin

    # ---- fused against unfused master-cast steps, in alternation ----
    x, y = (torch.as_tensor(a, device="cuda") for a in trained["fit_batch"])
    runs, ms = {False: [], True: []}, {False: [], True: []}
    for fused in (False, True) * FUSED_PAIRS:
        net.params, net.state, net.updater_state = (clone_tree(t)
                                                    for t in init)
        net.iteration = 0
        step = net._build_train_step(fused_cast=fused)
        for i in range(FUSED_STEPS):
            torch.cuda.synchronize()
            ta = time.perf_counter()
            step((x,), (y,), (None,), (None,))
            torch.cuda.synchronize()
            if i:
                ms[fused].append((time.perf_counter() - ta) * 1e3)
            net.iteration += 1
        runs[fused].append(flat(net.params, net.updater_state))
    unfused = runs[False]
    checks = [spread_check_many(unfused[:2], c,
                                f"[train-bf16] fused run {i + 1} vs unfused")
              for i, c in enumerate(runs[True])]
    parity = max(checks, key=lambda c: c["candidate_diff"])
    fused_ms = {"fused": statistics.median(ms[True]),
                "unfused": statistics.median(ms[False])}
    log(f"[train-bf16] fused vs unfused master-cast step, {FUSED_STEPS} "
        f"steps a run, {FUSED_PAIRS} runs of each in alternation: two "
        f"unfused runs differ by {parity['reference_spread']:.3g}, the "
        f"fused runs from the nearer by at most "
        f"{parity['candidate_diff']:.3g} (params and updater state; "
        f"{parity['rule']}); step {fused_ms['fused']:.3f} ms fused against "
        f"{fused_ms['unfused']:.3f} unfused (medians of "
        f"{len(ms[True])}: steps 2-{FUSED_STEPS} of each run; fused "
        + " ".join(f"{v:.1f}" for v in ms[True]) + ", unfused "
        + " ".join(f"{v:.1f}" for v in ms[False]) + ")")
    del runs, unfused

    # ---- the main path: fit, counts from 0, read after ----
    net.params, net.state, net.updater_state = init
    net.iteration = 0
    net._train_step = None
    it = TimedBatches(net, x, y, BF16_STEPS)
    k1.launches = k1.bwd_launches = 0
    k1.bf16_launches = k1.bf16_bwd_launches = 0
    fe.reset_counters()
    net.fit(as_iterator(it))
    torch.cuda.synchronize()
    launches = (k1.launches, k1.bwd_launches)
    bf16 = (k1.bf16_launches, k1.bf16_bwd_launches)
    decisions, upd = dict(fe.counters()), fe.updater_counters()
    want = BF16_STEPS * LAUNCHES_PER_FORWARD
    if launches != (want, want) or bf16 != launches or \
            decisions["fused"] != want or \
            any(v for k, v in decisions.items() if k != "fused") or \
            upd != {"fused_updater": 1, "fallback_updater_dtype": 0,
                    "fallback_updater_penalty": 0}:
        raise AssertionError(f"[train-bf16] K1/K2 {launches} (bf16 {bf16}) "
                             f"for {BF16_STEPS} steps, decisions "
                             f"{decisions}, updater {upd}")
    losses = [float(v) for v in it.losses]
    f32 = trained["losses"][:BF16_STEPS]
    n = BF16_REF_STEPS
    share, f32_share = band_shares(losses[:n], cpu_losses), \
        band_shares(f32[:n], cpu_losses)
    jax_band = band_shares(losses, f32)
    log(f"[train-bf16] fit, batch {TRAIN_BATCH}, {BF16_STEPS} steps: losses "
        + " ".join(f"{v:.4f}" for v in losses) + f"; the CPU plain path's "
        f"bf16, the first {n} ({cpu_fit_s:.1f} s): "
        + " ".join(f"{v:.4f}" for v in cpu_losses)
        + "; [train]'s float32 " + " ".join(f"{v:.4f}" for v in f32)
        + f"; steps 1-{n}: worst share of the JAX band (rtol {BF16_RTOL}, "
        f"atol {BF16_ATOL}) around the CPU's bf16 losses {max(share):.3g} "
        f"at step {share.index(max(share)) + 1} (gate {BF16_REF_SHARE}), "
        f"float32's {max(f32_share):.3g} at step "
        f"{f32_share.index(max(f32_share)) + 1} (must exceed the gate); "
        f"share of the JAX band around float32's by step "
        + " ".join(f"{v:.3g}" for v in jax_band) + f" (gate 1 from step "
        f"{n + 1}); {want} bf16 K1 + {want} bf16 K2, decisions {decisions}, "
        f"updater {upd}")
    if max(share) > BF16_REF_SHARE or max(jax_band[n:]) > 1.0 or \
            not all(np.isfinite(losses)) or not losses[-1] < 0.01 * losses[0]:
        raise AssertionError("[train-bf16] losses leave the CPU plain path's "
                             "bf16 band or [train]'s float32 band, or do "
                             "not fall")
    if not max(f32_share) > BF16_REF_SHARE:
        raise AssertionError("[train-bf16] the loss gate does not part "
                             "float32 compute from bf16")
    for name, tree in (("masters", net.params),
                       ("updater state", net.updater_state),
                       ("BN statistics", net.state)):
        if any(t.dtype != torch.float32 for t in flat_leaves(tree)):
            raise AssertionError(f"[train-bf16] {name} left float32")
    median = statistics.median(it.step_ms()[1:])

    def one():
        net.fit(it.ds)
    dev_ms, k1_prof, k2_prof = profile_step_split(one)
    t_bf16 = bf16_path_times(k1, k1_path_calls(net, TRAIN_BATCH))
    log(f"[train-bf16] step {median:.3f} ms median of {BF16_STEPS - 1} "
        f"({TRAIN_BATCH * 1e3 / median:.1f} images/s; [train] "
        f"{trained['step_ms']:.3f} ms); device {dev_ms:.3f} ms a step (busy "
        f"share {dev_ms / median:.3f}; [train] {trained['device_ms']:.3f}), "
        f"profiled K1 {k1_prof:.3f} + K2 {k2_prof:.3f} ms; CUDA events over "
        f"the path's 53 calls: bf16 K1 {t_bf16['k1_ms']:.4f} ms (bound "
        f"{t_bf16['k1_bound_ms']:.4f}), K2 {t_bf16['k2_ms']:.4f} ms (bound "
        f"{t_bf16['k2_bound_ms']:.4f}), float32 K1 {f32_times[0]:.4f}, K2 "
        f"{f32_times[1]:.4f}; {t_bf16['cases']} bf16 path shapes held "
        f"against the plain versions (K2 dscale/dshift at most "
        f"{t_bf16['k2_sum_rel']:.3g} of the column's sum of |term|); "
        f"{time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "losses": losses,
            "cpu_losses": cpu_losses, "ref_share": max(share),
            "f32_ref_share": max(f32_share), "f32_band": max(jax_band),
            "parity": parity, "fused_ms": fused_ms, "grad_worst": worst[0], "step_ms": median,
            "images_per_s": TRAIN_BATCH * 1e3 / median, "device_ms": dev_ms,
            "busy_share": dev_ms / median, "k1_prof_ms": k1_prof,
            "k2_prof_ms": k2_prof, **{"path_" + k: v
                                      for k, v in t_bf16.items()}}


def peak_bytes(fn) -> int:
    """The allocator's peak over ``fn()`` above what was in use before."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def phase_train_accum(k1, fe, env, graph, trained) -> dict:
    """[train-accum]: [train]'s float32 ResNet-50 (its weights as [train]
    left them) with ``_build_train_step(accum_steps=4)`` at batch 128,
    microbatch 32. Gates: 4 x 53 K1 and 4 x 53 K2 a step, ``fused``
    only; the accumulated gradient at batch 32 with k = 4 by [train]'s
    float64 rule against the CPU plain path's. Peak memory against one
    batch-32 step."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.nn import microbatch
    from deeplearning4j_tpu_torch.nn import training
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    net = trained["net"]
    saved = (clone_tree(net.params), clone_tree(net.state),
             clone_tree(net.updater_state), net.iteration)
    rng = np.random.default_rng(8)

    # ---- the accumulated gradient at batch 32, k = 4 ----
    xg, yg = _batch(rng, TRAIN_BATCH)

    def acc_grads(m):
        xs = (m._tensor(xg),)
        ys = (m._tensor(yg),)

        def vg(p, s, xs_, ys_, fms, lms):
            return training.value_and_grad(
                p, lambda q: m._loss(q, s, xs_, ys_, fms, lms))
        with env.precision(m.device):
            return microbatch.accumulate_gradients(
                vg, m.params, m.state, ACCUM_STEPS,
                (xs, ys, (None,), (None,)),
                weight_fn=microbatch.multi_output_weight)[1]
    g_card = acc_grads(net)
    t1 = time.perf_counter()
    g_cpu = acc_grads(cpu_twin(graph, net))
    g_64 = acc_grads(cpu_twin(graph, net, "DOUBLE", lambda t: t.double()))
    cpu_s = time.perf_counter() - t1
    worst = grad_ratios([g_card], [g_cpu], [g_64], ())[0]
    log(f"[train-accum] accumulated gradient, batch {TRAIN_BATCH} in "
        f"{ACCUM_STEPS} microbatches (CPU float32 and float64 {cpu_s:.1f} "
        f"s): worst card/allowed ratio against float64 {worst[0]:.3g} at "
        f"{worst[1]} (card {worst[2]:.3g}, CPU float32 {worst[3]:.3g})")
    if worst[0] > 1.0:
        raise AssertionError("[train-accum] accumulated gradient out of "
                             "bounds")
    del g_card, g_cpu, g_64

    # ---- the main path: accumulated steps at batch 128 ----
    x, y = (torch.as_tensor(a, device="cuda")
            for a in _batch(rng, ACCUM_BATCH))
    step = net._build_train_step(accum_steps=ACCUM_STEPS)
    batch = ((x,), (y,), (None,), (None,))
    k1.launches = k1.bwd_launches = 0
    fe.reset_counters()
    ms, losses = [], []
    peak = 0
    for i in range(ACCUM_STEPS_RUN):
        torch.cuda.synchronize()
        ta = time.perf_counter()
        if i == 1:
            peak = peak_bytes(lambda: losses.append(step(*batch)))
        else:
            losses.append(step(*batch))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - ta) * 1e3)
        net.iteration += 1
    launches = (k1.launches, k1.bwd_launches)
    decisions = dict(fe.counters())
    want = ACCUM_STEPS_RUN * ACCUM_STEPS * LAUNCHES_PER_FORWARD
    if launches != (want, want) or decisions["fused"] != want or \
            any(v for k, v in decisions.items() if k != "fused"):
        raise AssertionError(f"[train-accum] K1/K2 {launches} for "
                             f"{ACCUM_STEPS_RUN} steps, decisions "
                             f"{decisions}")
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[train-accum] losses {losses}")
    b32 = DataSet(x[:TRAIN_BATCH], y[:TRAIN_BATCH])
    peak32 = peak_bytes(lambda: net.fit(b32))
    net.params, net.state, net.updater_state, net.iteration = saved
    net._train_step = None
    step_ms = statistics.median(ms[1:])
    log(f"[train-accum] batch {ACCUM_BATCH} = {ACCUM_STEPS} x "
        f"{ACCUM_BATCH // ACCUM_STEPS}: {ACCUM_STEPS * LAUNCHES_PER_FORWARD} "
        f"K1 + {ACCUM_STEPS * LAUNCHES_PER_FORWARD} K2 a step, losses "
        + " ".join(f"{v:.4f}" for v in losses) + f"; step {step_ms:.3f} ms "
        f"median of {ACCUM_STEPS_RUN - 1} ({ACCUM_BATCH * 1e3 / step_ms:.1f} "
        f"images/s); peak memory {peak / 2**20:.1f} MiB against "
        f"{peak32 / 2**20:.1f} MiB for one batch-{TRAIN_BATCH} fit step; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "grad_worst": worst[0],
            "step_ms": step_ms, "peak_bytes": peak, "peak_bytes_b32": peak32,
            "losses": losses}


def remat_k1_per_step(net, mode) -> int:
    """K1 launches of one rematerialized step from the segment plan: the
    forward's 53, and again each BatchNormalization of a segment the
    backward recomputes (every segment that saves a tensor: here every
    segment holding a BatchNormalization)."""
    from deeplearning4j_tpu_torch.nn import memory
    from deeplearning4j_tpu_torch.nn.layers.conv import BatchNormalization
    from deeplearning4j_tpu_torch.nn.vertices import LayerVertex
    policy = memory.resolve_policy(mode)
    bn = [isinstance(net._vertex_map[n][0], LayerVertex)
          and isinstance(net._vertex_map[n][0].layer, BatchNormalization)
          for n in net._topo]
    if not policy.remat:
        return sum(bn)
    recomputed = sum(sum(bn[s:e]) for s, e in
                     memory.segment_ranges(len(bn), policy.every))
    return sum(bn) + recomputed


def phase_remat(k1, fe, env, trained) -> dict:
    """[remat]: [train]'s float32 ResNet-50 under ``workspace_mode``
    "full" and "every_4" against "none", from one set of weights on one
    batch. Gates: the loss, gradients and new BN statistics of one
    forward and backward by the determinism rule ("none" run twice); on
    the main path, one ``fit`` step from 0-set counts: the K1 and K2
    launches the segment plan implies, ``fused`` decisions only, and the
    BN state it commits equal to its loss's new statistics within
    REMAT_BN_TOL (committed once); the fit step's peak memory and each
    mode's residual bytes printed beside "none"'s."""
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    net = trained["net"]
    saved = (clone_tree(net.params), clone_tree(net.state),
             clone_tree(net.updater_state), net.iteration)
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    x, y = (torch.as_tensor(a, device="cuda") for a in trained["fit_batch"])
    batch = DataSet(x, y)
    rows, vg_runs = {}, []
    for mode in ("none", "none") + REMAT_MODES:
        net.params, net.state, net.updater_state = (
            clone_tree(t) for t in saved[:3])
        net.iteration = saved[3]
        net.set_workspace_mode(mode)
        with env.precision(net.device):
            loss, grads, new_state = net._value_and_grad(
                (x,), (y,), (None,), (None,))
        vg_runs.append(flat(loss, grads, new_state))
        want_state = flat(new_state)
        del loss, grads, new_state
        # ---- the main path: one fit step, counts from 0, read after ----
        k1.launches = k1.bwd_launches = 0
        fe.reset_counters()
        peak = peak_bytes(lambda: net.fit(batch))
        launches = (k1.launches, k1.bwd_launches)
        want = (remat_k1_per_step(net, mode), LAUNCHES_PER_FORWARD)
        decisions = dict(fe.counters())
        if launches != want or decisions["fused"] != want[0] or \
                any(v for k, v in decisions.items() if k != "fused"):
            raise AssertionError(f"[remat] {mode}: K1/K2 {launches} in a fit "
                                 f"step, the segment plan says {want}; "
                                 f"{decisions}")
        bn_err = float((flat(net.state) - want_state).abs().max()
                       / want_state.abs().max())
        if bn_err > REMAT_BN_TOL:
            raise AssertionError(f"[remat] {mode}: the BN state one fit step "
                                 f"commits is {bn_err:.3g} from its loss's "
                                 f"new statistics (tolerance {REMAT_BN_TOL})")
        rep = net.memory_report(TRAIN_BATCH)
        rows.setdefault(mode, {"k1": launches[0], "k2": launches[1],
                               "peak_bytes": peak, "bn_commit_err": bn_err,
                               "residual_bytes": rep["residual_bytes"],
                               "activation_bytes": rep["activation_bytes"],
                               "report_peak_bytes": rep["peak_bytes"]})
    checks = {mode: spread_check_many(vg_runs[:2], vg_runs[2 + i],
                                      f"[remat] {mode} loss and gradients")
              for i, mode in enumerate(REMAT_MODES)}
    net.params, net.state, net.updater_state, net.iteration = saved
    net.set_workspace_mode("none")
    for mode, r in rows.items():
        extra = "" if mode == "none" else (
            f"; loss, gradients and new BN statistics {checks[mode]['rule']} "
            f"({checks[mode]['candidate_diff']:.3g} against none's "
            f"{checks[mode]['reference_spread']:.3g})")
        log(f"[remat] {mode}: {r['k1']} K1 + {r['k2']} K2 in a fit step, "
            f"its peak {r['peak_bytes'] / 2**20:.1f} MiB (none "
            f"{rows['none']['peak_bytes'] / 2**20:.1f}), residuals "
            f"{r['residual_bytes'] / 2**20:.1f} MiB, of them activations "
            f"{r['activation_bytes'] / 2**20:.1f} (none "
            f"{rows['none']['activation_bytes'] / 2**20:.1f}); the BN state "
            f"the step commits {r['bn_commit_err']:.3g} from its loss's "
            f"(tolerance {REMAT_BN_TOL})" + extra)
    log(f"[remat] {time.perf_counter() - t0:.1f} s")
    return {"rows": rows, "checks": checks}


def lenet_arrays(it):
    """The features and labels of every batch of ``it`` as two arrays."""
    it.reset()
    xs, ys = zip(*((d.features, d.labels) for d in it))
    it.reset()
    return np.concatenate(xs), np.concatenate(ys)


def phase_lenet_solver(k1, fe, env, models, train) -> dict:
    """[lenet-solver]: zoo ``lenet()`` with ``optimization_algo("LBFGS",
    iterations=5)`` on the synthetic tier, SOLVER_BATCHES batches of 125.
    Gates: the first batch's per-iteration losses within SOLVER_LOSS_TOL
    (relative) of the CPU plain path's from the same weights, over the
    iterations both made (the line search branches on float32 loss
    comparisons: where the card and the CPU take other branches, the
    iteration and evaluation counts differ and the log says so); every
    batch's loss falls; 2 K1 + 2 K2 a function evaluation, ``fused``
    only."""
    import dataclasses
    from deeplearning4j_tpu_torch.data.dataset import ListDataSetIterator
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    conf = dataclasses.replace(
        models.lenet_config(seed=LENET_SEED), optimization_algo="LBFGS",
        solver_iterations=SOLVER_ITERATIONS)
    net = MultiLayerNetwork(conf).init(device="cuda")
    cpu = MultiLayerNetwork(conf).init(device="cpu")
    cpu.params = {k: {n: t.detach().cpu().clone() for n, t in p.items()}
                  for k, p in net.params.items()}
    train.reset()
    batches = [DataSet(d.features, d.labels)
               for _, d in zip(range(SOLVER_BATCHES), train)]
    train.reset()
    cpu.fit(batches[0])
    cpu_hist = list(cpu._solver.opt.history)
    cpu_evals = len(cpu._solver.evaluations)
    k1.launches = k1.bwd_launches = 0
    fe.reset_counters()
    evals, firsts, lasts, hist = 0, [], [], None
    for i, b in enumerate(batches):
        net.fit(ListDataSetIterator([b]))
        s = net._solver
        evals += len(s.evaluations)
        firsts.append(s.evaluations[0])
        lasts.append(net.score())
        if i == 0:
            hist = list(s.opt.history)
            card_evals = len(s.evaluations)
    torch.cuda.synchronize()
    launches = (k1.launches, k1.bwd_launches)
    decisions = dict(fe.counters())
    per = LENET_CONVS
    if launches != (per * evals, per * evals) or \
            decisions["fused"] != per * evals or \
            any(v for k, v in decisions.items() if k != "fused"):
        raise AssertionError(f"[lenet-solver] K1/K2 {launches} for {evals} "
                             f"function evaluations, decisions {decisions}")
    errs = [abs(a - b) / abs(b) for a, b in zip(hist, cpu_hist)]
    branch = "the same branches" if (len(hist), card_evals) == \
        (len(cpu_hist), cpu_evals) else (
            f"a different branch: {len(hist)} iterations and {card_evals} "
            f"evaluations against the CPU's {len(cpu_hist)} and {cpu_evals}")
    log(f"[lenet-solver] LBFGS({SOLVER_ITERATIONS}), {SOLVER_BATCHES} batches "
        f"of {LENET_BATCH}: first batch per-iteration losses "
        + " ".join(f"{v:.5f}" for v in hist) + " against the CPU's "
        + " ".join(f"{v:.5f}" for v in cpu_hist) + f" (worst rel err "
        f"{max(errs) if errs else float('nan'):.3g}, tolerance "
        f"{SOLVER_LOSS_TOL}; {branch}); each batch's loss from "
        + ", ".join(f"{a:.4f} to {b:.4f}" for a, b in zip(firsts, lasts))
        + f"; {evals} function evaluations, {per} K1 + {per} K2 each; "
        f"{time.perf_counter() - t0:.1f} s")
    if not errs or max(errs) > SOLVER_LOSS_TOL:
        raise AssertionError("[lenet-solver] the first batch's iterations "
                             "disagree with the CPU plain path")
    if not all(b < a for a, b in zip(firsts, lasts)):
        raise AssertionError("[lenet-solver] a batch's loss did not fall")
    return {"launches": launches, "evaluations": evals, "history": hist,
            "cpu_history": cpu_hist, "worst_rel_err": max(errs),
            "branch": branch}


def phase_lenet_on_device(k1, fe, env, models, train, test,
                          lenet_step_ms) -> dict:
    """[lenet-on-device]: zoo ``lenet()`` through ``fit_on_device`` over
    the 8000 synthetic digits, batch 125, LENET_EPOCHS epochs (uploaded
    once; no host sync inside an epoch: the CUDA sync-debug mode counts
    any). Gates: test accuracy at least LENET_MIN_ACCURACY; the first
    LENET_PARITY_STEPS losses within LENET_LOSS_TOL of the card's own
    per-batch ``fit`` from the same weights; 2 K1 + 2 K2 a step."""
    import warnings
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    x, y = lenet_arrays(train)
    net = models.lenet(seed=LENET_SEED)
    ref = models.lenet(seed=LENET_SEED)
    ref.params = clone_tree(net.params)
    ref_losses = []
    for i in range(LENET_PARITY_STEPS):
        s = slice(i * LENET_BATCH, (i + 1) * LENET_BATCH)
        ref.fit(x[s], y[s])
        ref_losses.append(ref.score())
    del ref
    steps = LENET_EPOCHS * (len(x) // LENET_BATCH)
    k1.launches = k1.bwd_launches = 0
    fe.reset_counters()
    torch.cuda.synchronize()
    ta = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            losses = net.fit_on_device(x, y, epochs=LENET_EPOCHS,
                                       batch_size=LENET_BATCH)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    wall = time.perf_counter() - ta
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    launches = (k1.launches, k1.bwd_launches)
    decisions = dict(fe.counters())
    if launches != (2 * steps, 2 * steps) or \
            decisions["fused"] != 2 * steps or \
            any(v for k, v in decisions.items() if k != "fused"):
        raise AssertionError(f"[lenet-on-device] K1/K2 {launches} for "
                             f"{steps} steps, decisions {decisions}")
    acc = net.evaluate(test).accuracy()
    errs = [abs(float(a) - b) / abs(b)
            for a, b in zip(losses[:LENET_PARITY_STEPS], ref_losses)]
    step_ms = wall * 1e3 / steps
    log(f"[lenet-on-device] fit_on_device, {LENET_EPOCHS} epochs x "
        f"{steps // LENET_EPOCHS} steps of {LENET_BATCH}: {step_ms:.4f} ms a "
        f"step over the whole call, the upload and the one read at its end "
        f"included ({LENET_BATCH * 1e3 / step_ms:.1f} images/s; [lenet]'s "
        f"fit {lenet_step_ms:.4f} ms); {syncs} synchronizing calls inside "
        f"(the final loss read included); the first "
        f"{LENET_PARITY_STEPS} losses "
        + ", ".join(f"{float(a):.6f}/{b:.6f}" for a, b in
                    zip(losses, ref_losses))
        + f" against per-batch fit (worst rel err {max(errs):.3g}, "
        f"tolerance {LENET_LOSS_TOL}); accuracy {acc:.4f}; 2 K1 + 2 K2 a "
        f"step; {time.perf_counter() - t0:.1f} s")
    if max(errs) > LENET_LOSS_TOL or acc < LENET_MIN_ACCURACY or \
            syncs > ON_DEVICE_MAX_SYNCS:
        raise AssertionError("[lenet-on-device] losses, accuracy or host "
                             "syncs out of bounds")
    return {"launches": launches, "step_ms": step_ms, "accuracy": acc,
            "loss_rel_err": max(errs), "syncs": syncs}


def attn_operand(B, H, T, d, dtype, layout, gen):
    """A [B, H, T, d] operand on the card: packed, or the head split of a
    [B, T, H*d] projection."""
    if layout == "packed":
        return torch.randn(B, H, T, d, generator=gen,
                           device="cuda").to(dtype)
    return torch.randn(B, T, H, d, generator=gen,
                       device="cuda").to(dtype).transpose(1, 2)


def check_attn_case(k3, q, k, v, kb, scale, where, err) -> None:
    """K3 twice (bitwise equal) against its plain version; folds the
    errors into ``err``."""
    got = k3.flash_attention_fwd(q, k, v, kb, scale)
    again = k3.flash_attention_fwd(q, k, v, kb, scale)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{where} is not deterministic")
    o, m, l = k3.flash_attention_fwd_reference(q, k, v, kb, scale)
    e_m = float(((got[1] - m).abs() / m.abs().clamp(min=1.0)).max())
    e_l = float(((got[2] - l).abs() / l).max())
    if q.dtype == torch.float32:
        e = float((got[0] - o).abs().max())
        bad = e > ATTN_F32_TOL
        err["float32"] = max(err["float32"], e)
    else:
        e = k3.ulp_error(got[0], o)
        bad = e > ATTN_ULP_TOL
        key = "ulp_" + str(q.dtype)[6:]
        err[key] = max(err[key], e)
    if bad or e_m > ATTN_F32_TOL or e_l > ATTN_F32_TOL:
        raise AssertionError(f"{where} disagrees with its plain version: "
                             f"o {e}, m {e_m}, l {e_l}")
    err["m_rel"] = max(err["m_rel"], e_m)
    err["l_rel"] = max(err["l_rel"], e_l)


def phase_kernel_attn(k3) -> dict:
    """K3 against its plain version in both operand layouts, twice per
    case for determinism; returns the float32 times at BERT-base batch 32
    (head-split operands, as the BERT path gives them) and the errors."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    neg = float(torch.finfo(torch.float32).min)
    err = {"float32": 0.0, "ulp_bfloat16": 0.0, "ulp_float16": 0.0,
           "m_rel": 0.0, "l_rel": 0.0}
    times, per_dtype, cases = {}, {}, 0
    for B, H, Tq, Tk, d in ATTN_SHAPES:
        lengths = torch.randint(1, Tk + 1, (B,), generator=gen, device=dev)
        ragged = torch.where(torch.arange(Tk, device=dev)[None, :]
                             < lengths[:, None], 0.0, neg).contiguous()
        masked = ragged.clone()
        masked[0] = neg  # batch row 0: every key masked (uniform rows)
        scale = 1.0 / float(np.sqrt(d))
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for layout in ATTN_LAYOUTS:
                q, k, v = (attn_operand(B, H, T, d, dtype, layout, gen)
                           for T in (Tq, Tk, Tk))
                for tag, kb in (("none", None), ("ragged", ragged),
                                ("masked", masked)):
                    check_attn_case(
                        k3, q, k, v, kb, scale,
                        f"K3 {str(dtype)[6:]} {(B, H, Tq, Tk, d)} {layout} "
                        f"bias={tag}", err)
                    cases += 1
            if dtype == torch.float16:
                continue
            # timed on the last layout: the head split the BERT path gives
            mask4 = ragged[:, None, None, :].to(dtype)
            ms, host = time_ms(
                lambda: k3.flash_attention_fwd(q, k, v, ragged, scale))
            plain, _ = time_ms(
                lambda: k3.flash_attention_fwd_reference(q, k, v, ragged,
                                                         scale))
            lib, _ = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask4, scale=scale))
            bound, by = k3.bound_ms(B, H, Tq, Tk, d, q.element_size())
            occ = k3.fwd_occupancy(d, dtype)
            if dtype == torch.float32:
                times[(B, H, Tq, Tk, d)] = (ms, plain, lib, host, bound, by)
            if (B, H, Tq, Tk, d) == ATTN_SHAPES[0]:
                per_dtype[str(dtype)[6:]] = {
                    "ms": ms, "plain_ms": plain, "library_ms": lib,
                    "bound_ms": bound, "bound_by": by, "host_ms": host,
                    "occupancy": occ}
            log(f"[kernel-attn] K3 {str(dtype)[6:]:8s} B={B:2d} H={H:2d} "
                f"Tq={Tq:3d} Tk={Tk:3d} d={d:3d} {ATTN_LAYOUTS[-1]} "
                f"ms={ms:.5f} plain_ms={plain:.5f} bound_ms={bound:.5f} "
                f"({by}) library_ms={lib:.5f} host_ms={host:.5f}; resources "
                f"{occ}")
            del q, k, v
    log(f"[kernel-attn] K3 matches its plain version and repeats bit for "
        f"bit: {cases} cases (5 shapes x 3 dtypes x {len(ATTN_LAYOUTS)} "
        f"layouts x (no bias, ragged, masked rows)); max abs err float32 "
        f"{err['float32']:.3g} (tolerance {ATTN_F32_TOL}); bfloat16 "
        f"{err['ulp_bfloat16']:.3g} ulp, float16 {err['ulp_float16']:.3g} "
        f"ulp (tolerance {ATTN_ULP_TOL}); m {err['m_rel']:.3g}, l "
        f"{err['l_rel']:.3g} relative")
    return {"times": times, "bert_b32": per_dtype, "max_err": err,
            "cases": cases}


def phase_bert(k1, k3, fa, env) -> dict:
    from deeplearning4j_tpu_torch.autodiff.fusion import fuse_attention
    from deeplearning4j_tpu_torch.models.bert import OUTPUT, bert_base
    from deeplearning4j_tpu_torch.tools.profile_bert import profile, request
    from deeplearning4j_tpu_torch.utils.convert import samediff_from_numpy
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    sd = bert_base(seed=0, device="cuda", seq_len=BERT_SEQ)
    n_params = sum(int(t.numel()) for n, t in sd._values.items()
                   if n in sd.variables())
    report = fuse_attention(sd)
    log(f"[bert] bert_base on cuda: {n_params} params, "
        f"{time.perf_counter() - t0:.1f} s; {report}")
    if (report.matched, report.unmatched) != (BERT_LAYERS, 0):
        raise AssertionError(f"fuse_attention: {report} {report.reasons}")
    rng = np.random.default_rng(4)
    feeds = {n: request(rng, n, BERT_SEQ) for n in BERT_REQUESTS}
    for n in BERT_REQUESTS:  # warm-up: cuBLAS handles, allocator pools
        sd.output(feeds[n], [OUTPUT])

    # ---- the BERT serving path: counts from 0, read after the last forward
    k1.launches = k1.bwd_launches = k3.launches = 0
    fa.reset_counters()
    forwards = 0
    rows = {}
    for n in BERT_REQUESTS:
        for _ in range(5):
            before = k3.launches
            y = sd.output(feeds[n], [OUTPUT])[OUTPUT]
            forwards += 1
            if k3.launches - before != BERT_LAYERS:
                raise AssertionError(f"request of {n}: {k3.launches - before}"
                                     f" K3 launches, expected {BERT_LAYERS}")
        if y.shape != (n, BERT_SEQ, 768) or not np.isfinite(y).all():
            raise AssertionError(f"request of {n}: bad output {y.shape}")
        row = profile(sd, feeds[n])
        forwards += 10 + 1 + 3
        rows[n] = row
        log(f"[bert] request of {n:2d} x {BERT_SEQ}: wall "
            f"{row['wall_ms_median']:.3f} ms (median of 10), "
            f"{row['sequences_per_s']:.1f} sequences/s; device "
            f"{row['device_ms']:.3f} ms (busy share "
            f"{row['device_busy_share']:.3f}), K3 {row['k3_device_ms']:.3f} "
            f"ms in {row['k3_launches_per_request']:.0f} launches")
        log("[bert] top kernels (ms per request): " + "; ".join(
            f"{k[:50]} {t:.3f} x{c}" for k, t, c in row["top_kernels_ms"][:5]))
    parity = request(np.random.default_rng(5), 2, BERT_SEQ)
    got = sd.output(parity, [OUTPUT])[OUTPUT]
    forwards += 1
    launches, decisions = k3.launches, fa.counters()
    if launches != forwards * BERT_LAYERS or decisions["fused"] != launches \
            or any(v for k, v in decisions.items() if k != "fused") \
            or k1.launches or k1.bwd_launches:
        raise AssertionError(f"BERT serving path: {launches} K3 launches for "
                             f"{forwards} forwards, decisions {decisions}, "
                             f"K1/K2 {k1.launches}/{k1.bwd_launches}")

    # the card against the port's plain path on the CPU, same weights
    t0 = time.perf_counter()
    cpu = samediff_from_numpy(sd.to_json(), {n: sd.get_value(n)
                                             for n in sd._values}, "cpu")
    want = cpu.output(parity, [OUTPUT])[OUTPUT]
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    log(f"[bert] card vs CPU plain path, batch 2: max|diff|/max|ref| "
        f"{rel:.3g} (tolerance {BERT_REL_TOL}; CPU "
        f"{time.perf_counter() - t0:.1f} s); {launches} K3 launches in "
        f"{forwards} forwards, decisions {decisions}")
    if not rel <= BERT_REL_TOL:
        raise AssertionError("BERT on the card disagrees with the CPU plain "
                             "path")
    return {"launches": launches, "forwards": forwards, "rows": rows,
            "rel_err": rel}


def check_attn_bwd_case(k3, q, k, v, do, kb, scale, where, err) -> None:
    """The fused backward twice (bitwise equal) and its dq-only and
    dk/dv-only calls (the same bits) against the plain versions, fed K3's
    m and l; folds the errors into ``err``."""
    o, m, l = k3.flash_attention_fwd(q, k, v, kb, scale)
    di = k3.attention_di(o, do)
    args = (q, k, v, kb, m, l, di, do, scale)
    got = k3.flash_attention_bwd(*args)
    again = k3.flash_attention_bwd(*args)
    alone = (k3.flash_attention_bwd_dq(*args),
             *k3.flash_attention_bwd_dkv(*args))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{where} is not deterministic")
    if not all(torch.equal(a, b) for a, b in zip(got, alone)):
        raise AssertionError(f"{where}: the dq-only or dk/dv-only call "
                             f"differs from the fused one")
    want = (k3.flash_attention_bwd_dq_reference(*args),
            *k3.flash_attention_bwd_dkv_reference(*args))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if q.dtype == torch.float32:
            e = float(((g - w).abs() / w.abs().clamp(min=1.0)).max())
            bad = e > ATTN_BWD_F32_TOL
            key = "float32"
            err["abs_float32"] = max(err["abs_float32"],
                                     float((g - w).abs().max()))
        else:
            e = k3.ulp_error(g, w)
            bad = e > ATTN_ULP_TOL
            key = "ulp_" + str(q.dtype)[6:]
        err[key] = max(err[key], e)
        if bad:
            raise AssertionError(f"{where}: {name} disagrees with its plain "
                                 f"version ({e})")


def phase_kernel_attn_bwd(k3) -> dict:
    """The fused backward (K4 + K5) against its plain versions in both
    operand layouts, twice per case for determinism; returns the times at
    BERT-base batch 32 (head-split operands, as the BERT path gives them)
    in float32 and bfloat16, and the errors."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    neg = float(torch.finfo(torch.float32).min)
    err = {"float32": 0.0, "abs_float32": 0.0, "ulp_bfloat16": 0.0,
           "ulp_float16": 0.0}
    times, cases = {}, 0
    shapes = ATTN_SHAPES + ATTN_BWD_EXTRA_SHAPES
    for B, H, Tq, Tk, d in shapes:
        lengths = torch.randint(1, Tk + 1, (B,), generator=gen, device=dev)
        ragged = torch.where(torch.arange(Tk, device=dev)[None, :]
                             < lengths[:, None], 0.0, neg).contiguous()
        masked = ragged.clone()
        masked[0] = neg  # batch row 0: every key masked (uniform rows)
        scale = 1.0 / float(np.sqrt(d))
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for layout in ATTN_LAYOUTS:
                q, k, v, do = (attn_operand(B, H, T, d, dtype, layout, gen)
                               for T in (Tq, Tk, Tk, Tq))
                for tag, kb in (("none", None), ("ragged", ragged),
                                ("masked", masked)):
                    check_attn_bwd_case(
                        k3, q, k, v, do, kb, scale,
                        f"K4+K5 {str(dtype)[6:]} {(B, H, Tq, Tk, d)} "
                        f"{layout} bias={tag}", err)
                    cases += 1
            if dtype == torch.float16 or (B, H, Tq, Tk, d) != ATTN_SHAPES[0]:
                continue
            # timed at BERT-base batch 32 on the last layout: the head split
            # the BERT path gives
            o, m, l = k3.flash_attention_fwd(q, k, v, ragged, scale)
            di = k3.attention_di(o, do)
            args = (q, k, v, ragged, m, l, di, do, scale)
            ms, host = time_ms(lambda: k3.flash_attention_bwd(*args))
            dq_ms, _ = time_ms(lambda: k3.flash_attention_bwd_dq(*args))
            dkv_ms, _ = time_ms(lambda: k3.flash_attention_bwd_dkv(*args))
            plain, _ = time_ms(lambda: (
                k3.flash_attention_bwd_dq_reference(*args),
                k3.flash_attention_bwd_dkv_reference(*args)))
            plain_dkv, _ = time_ms(
                lambda: k3.flash_attention_bwd_dkv_reference(*args))
            bound, by = k3.bound_ms_bwd(B, H, Tq, Tk, d, q.element_size(),
                                        "fused")
            bound_dkv, by_dkv = k3.bound_ms_bwd(B, H, Tq, Tk, d,
                                                q.element_size(), "dkv")
            # the library's backward of the same attention: dq, dk, dv
            # from one autograd.grad of SDPA's output, its forward outside
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=ragged[:, None, None, :].to(dtype),
                scale=scale)
            lib, _ = time_ms(lambda: torch.autograd.grad(
                out, (qs, ks, vs), do, retain_graph=True))
            lib_dkv, _ = time_ms(lambda: torch.autograd.grad(
                out, (ks, vs), do, retain_graph=True))
            del qs, ks, vs, out
            times[str(dtype)[6:]] = {
                "ms": ms, "dq_only_ms": dq_ms, "dkv_only_ms": dkv_ms,
                "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                "bound_by": by, "host_ms": host,
                "plain_dkv_ms": plain_dkv, "library_dkv_ms": lib_dkv,
                "bound_dkv_ms": bound_dkv, "bound_dkv_by": by_dkv,
                "occupancy": k3.bwd_occupancy(d, dtype)}
            log(f"[kernel-attn-bwd] K4+K5 {str(dtype)[6:]:8s} B={B:2d} "
                f"H={H:2d} Tq={Tq:3d} Tk={Tk:3d} d={d:3d} "
                f"{ATTN_LAYOUTS[-1]} ms={ms:.5f} (dq only {dq_ms:.5f}, dk/dv "
                f"only {dkv_ms:.5f}) plain_ms={plain:.5f} "
                f"bound_ms={bound:.5f} ({by}) library_ms={lib:.5f} (SDPA "
                f"backward, dq+dk+dv) host_ms={host:.5f}; resources "
                f"{times[str(dtype)[6:]]['occupancy']}")
            del q, k, v, do
    log(f"[kernel-attn-bwd] the fused K4+K5 matches its plain versions, "
        f"repeats bit for bit and gives the same bits asked for dq alone or "
        f"dk and dv alone: {cases} cases ({len(shapes)} shapes x 3 dtypes x "
        f"{len(ATTN_LAYOUTS)} layouts x (no bias, ragged, masked rows)); "
        f"float32 max err {err['float32']:.3g} of max(1, |ref|) (tolerance "
        f"{ATTN_BWD_F32_TOL}; max abs err {err['abs_float32']:.3g}); "
        f"bfloat16 {err['ulp_bfloat16']:.3g} ulp, float16 "
        f"{err['ulp_float16']:.3g} ulp (tolerance {ATTN_ULP_TOL})")
    return {"times": times, "max_err": err, "cases": cases}


def only_fused(fa, fe) -> bool:
    """No attention or epilogue decision other than ``fused`` counted."""
    return not any(v for k, v in list(fa.counters().items())
                   + list(fe.counters().items()) if k != "fused")


class FitLaunchCheck:
    """A ``fit`` listener that holds each step of a BERT fine-tune to its
    launches of K1-K7 (``per_step``, by kernel) and only ``fused``
    attention and epilogue decisions."""

    def __init__(self, fa, fe, per_step):
        from deeplearning4j_tpu_torch.tools.profile_bert import launch_counts
        self.counts, self.fa, self.fe, self.per_step = launch_counts, fa, \
            fe, per_step
        self.last = launch_counts()

    def iteration_done(self, model, iteration, epoch):
        now = self.counts()
        got = {k: v - self.last[k] for k, v in now.items()}
        self.last = now
        if got != self.per_step or not only_fused(self.fa, self.fe):
            raise AssertionError(f"fit step {iteration}: launches {got}, "
                                 f"expected {self.per_step}; decisions "
                                 f"{self.fa.counters()} {self.fe.counters()}")

    def on_epoch_end(self, model):
        pass


def phase_bert_fit(k1, k3, fa, fe, env) -> dict:
    from deeplearning4j_tpu_torch.autodiff.fusion import fuse_attention
    from deeplearning4j_tpu_torch.models.bert import (
        attach_classifier_head, bert_base, fine_tune_feeds)
    from deeplearning4j_tpu_torch.tools.profile_bert import profile_fit
    from deeplearning4j_tpu_torch.utils.convert import samediff_from_numpy
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    sd = bert_base(seed=0, device="cuda", seq_len=BERT_SEQ)
    report = fuse_attention(sd)
    if (report.matched, report.unmatched) != (BERT_LAYERS, 0):
        raise AssertionError(f"fuse_attention: {report} {report.reasons}")
    attach_classifier_head(sd, seed=0)
    names = sd.variables()
    n_params = sum(int(sd._values[n].numel()) for n in names)
    log(f"[bert-fit] bert_base + classifier head on cuda: {n_params} "
        f"params in {len(names)} VARIABLEs, {time.perf_counter() - t0:.1f} "
        f"s; {report}")

    # ---- parity: one batch-2 step on the card vs the CPU plain path ----
    t0 = time.perf_counter()
    parity = fine_tune_feeds(np.random.default_rng(6), FIT_PARITY_BATCH,
                             BERT_SEQ)
    loss_name = sd.loss_name
    loss_g = float(sd.output(parity, [loss_name])[loss_name])
    grads_g = sd.grad(parity)
    values = {n: sd.get_value(n) for n in sd._values}
    cpu = samediff_from_numpy(sd.to_json(), values, "cpu")
    loss_c = float(cpu.output(parity, [loss_name])[loss_name])
    grads_c = cpu.grad(parity)
    cpu._values = {n: t.double() if t.is_floating_point() else t
                   for n, t in cpu._values.items()}
    grads_64 = cpu.grad(parity)
    del cpu
    e_loss = abs(loss_g - loss_c) / abs(loss_c)
    worst, bad = (0.0, "", 0.0, 0.0), []
    for n in names:
        e_card = rel_err(grads_g[n], grads_64[n])
        e_cpu = rel_err(grads_c[n], grads_64[n])
        allowed = max(TRAIN_GRAD_TOL, GRAD_NOISE_FACTOR * e_cpu)
        if e_card / allowed >= worst[0]:
            worst = (e_card / allowed, n, e_card, e_cpu)
        if e_card > allowed:
            bad.append(n)
    log(f"[bert-fit] card vs CPU plain path, one batch-{FIT_PARITY_BATCH} x "
        f"{BERT_SEQ} step ({time.perf_counter() - t0:.1f} s): loss "
        f"{loss_g:.6f} vs {loss_c:.6f} (rel err {e_loss:.3g}, tolerance "
        f"{FIT_LOSS_TOL}); against the CPU float64 gradient the worst "
        f"card/allowed ratio is {worst[0]:.3g} at {worst[1]} (card "
        f"{worst[2]:.3g}, CPU float32 {worst[3]:.3g}; allowed "
        f"max({TRAIN_GRAD_TOL}, {GRAD_NOISE_FACTOR} x CPU float32)); "
        f"{len(names)} VARIABLEs")
    if e_loss > FIT_LOSS_TOL or bad:
        raise AssertionError(f"the fine-tune step on the card disagrees with "
                             f"the CPU plain path (gradients out of bounds: "
                             f"{bad})")
    del grads_g, grads_c, grads_64, values

    # ---- the main path: counts from 0, read after the last fit ----
    feed = fine_tune_feeds(np.random.default_rng(7), FIT_BATCH, BERT_SEQ)
    sd.fit(feed)  # warm-up: cuBLAS handles, allocator pools, the kernels
    k1.launches = k1.bwd_launches = 0
    k3.launches = k3.launches_bwd = k3.launches_dq = k3.launches_dkv = 0
    fa.reset_counters()
    fe.reset_counters()
    check = FitLaunchCheck(fa, fe, {
        "k1": 0, "k2": 0, "k3": BERT_LAYERS, "bwd": BERT_LAYERS,
        "k4": BERT_LAYERS, "k5": BERT_LAYERS, "k6": 0, "k7": 0})
    row = profile_fit(sd, feed, walls=FIT_STEPS - 1, listeners=[check])
    steps = FIT_STEPS + 1 + 3
    # K3, the fused backward, and of those the launches writing dq (K4's
    # output) and dk and dv (K5's)
    launches = (k3.launches, k3.launches_bwd, k3.launches_dq,
                k3.launches_dkv)
    decisions, copies = fa.counters(), fa.do_copies
    sentinel = sd.resilience_counters()
    losses = row["losses"]
    log(f"[bert-fit] fit, batch {FIT_BATCH} x {BERT_SEQ}, {FIT_STEPS} steps "
        f"in one call: losses " + " ".join(f"{v:.5f}" for v in losses))
    if launches != (steps * BERT_LAYERS,) * 4 \
            or decisions["fused"] != launches[0] \
            or any(v for k, v in decisions.items() if k != "fused") \
            or k1.launches or k1.bwd_launches or copies \
            or sentinel["bad_total"]:
        raise AssertionError(f"fine-tune path: K3, K4+K5, dq, dk/dv launches "
                             f"{launches} "
                             f"for {steps} steps, decisions {decisions}, "
                             f"K1/K2 {k1.launches}/{k1.bwd_launches}, do "
                             f"copies {copies}, sentinel {sentinel}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"fine-tune loss not finite and falling: "
                             f"{losses}")
    log(f"[bert-fit] step {row['step_ms_median']:.3f} ms median of "
        f"{FIT_STEPS - 1} ({row['sequences_per_s']:.1f} sequences/s); device "
        f"{row['device_ms']:.3f} ms per step (busy share "
        f"{row['device_busy_share']:.3f}); K3 {row['k3_device_ms']:.3f} ms, "
        f"K4+K5 {row['bwd_device_ms']:.3f} ms per step; {BERT_LAYERS} K3 + "
        f"{BERT_LAYERS} fused K4+K5 launches (each writing dq, dk and dv) in "
        f"each of {steps} steps; decisions {decisions}; "
        f"sentinel {sentinel}")
    log("[bert-fit] top kernels (ms per step): " + "; ".join(
        f"{k[:60]} {t:.3f} x{c}" for k, t, c in row["top_kernels_ms"][:6]))
    return {"launches": launches, "steps": steps, "row": row,
            "parity": (e_loss, worst[0])}


def phase_kernel_lstm(k8) -> dict:
    """K8 against its plain version at LSTM_SHAPES x 3 dtypes x (contiguous,
    row-strided x), twice per case for determinism; returns the float32
    times at the path's shapes and the errors."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    err = {"float32": 0.0, "ulp_bfloat16": 0.0, "ulp_float16": 0.0}
    times, shapes, cases = {}, {}, 0
    torch.backends.cuda.matmul.allow_tf32 = False
    for B, F, U in LSTM_SHAPES:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            seq = (torch.rand(B, 3, F, generator=gen, device=dev) * 2 - 1
                   ).to(dtype)
            h = (torch.rand(B, U, generator=gen, device=dev) * 2 - 1
                 ).to(dtype)
            c = torch.randn(B, U, generator=gen, device=dev).to(dtype)
            w = (torch.randn(F, 4 * U, generator=gen, device=dev)
                 * (2.0 / (F + U)) ** 0.5).to(dtype)
            rw = (torch.randn(U, 4 * U, generator=gen, device=dev)
                  * (1.0 / U) ** 0.5).to(dtype)
            b = (torch.randn(4 * U, generator=gen, device=dev) * 0.1
                 ).to(dtype)
            for layout, x in (("contiguous", seq[:, 1].contiguous()),
                              ("strided", seq[:, 1])):
                got = k8.lstm_cell(x, h, c, w, rw, b, LSTM_FORGET_BIAS)
                again = k8.lstm_cell(x, h, c, w, rw, b, LSTM_FORGET_BIAS)
                torch.cuda.synchronize()
                where = f"K8 {str(dtype)[6:]} {(B, F, U)} {layout}"
                if not all(torch.equal(p, q) for p, q in zip(got, again)):
                    raise AssertionError(f"{where} is not deterministic")
                ref = k8.lstm_cell_reference(x, h, c, w, rw, b,
                                             LSTM_FORGET_BIAS)
                viol = max(k8.max_violation(g, r) for g, r in zip(got, ref))
                if dtype == torch.float32:
                    err["float32"] = max(err["float32"], max(
                        float((g - r).abs().max()) for g, r in zip(got, ref)))
                else:
                    key = "ulp_" + str(dtype)[6:]
                    err[key] = max(err[key], viol)
                if viol > 1.0:
                    raise AssertionError(
                        f"{where} disagrees with its plain version: "
                        f"{viol:.3g} x the tolerance")
                cases += 1
            if (B, F, U) in LSTM_PATH_SHAPES and dtype != torch.float16:
                x = seq[:, 1]
                ms, host = time_ms(lambda: k8.lstm_cell(
                    x, h, c, w, rw, b, LSTM_FORGET_BIAS), reps=50)
                plain, _ = time_ms(lambda: k8.lstm_cell_reference(
                    x, h, c, w, rw, b, LSTM_FORGET_BIAS), reps=50)
                # torch.lstm_cell computes the same step once its operands
                # are reordered to [i, f, g, o] (outside the timed window)
                ops = k8.torch_lstm_cell_operands(w, rw, b, LSTM_FORGET_BIAS)
                lib, _ = time_ms(lambda: torch.lstm_cell(x, (h, c), *ops),
                                 reps=50)
                bound, by = k8.bound_ms(B, F, U, x.element_size())
                # the same launch with an empty kernel: what any launch
                # costs under this timing
                floor, _ = time_ms(lambda: k8.launch_floor(B, F, U, dtype),
                                   reps=50)
                geo = k8.geometry(B, F, U, x.element_size())
                occ = k8.occupancy(B, F, U, dtype)
                if dtype == torch.float32:
                    times[(B, F, U)] = (ms, plain, lib, host, bound, by)
                    shapes[(B, F, U)] = {"floor_ms": floor, "geometry": geo,
                                         "occupancy": occ}
                log(f"[kernel-lstm] K8 {str(dtype)[6:]:8s} B={B:3d} F={F:3d} "
                    f"U={U:3d} strided ms={ms:.5f} plain_ms={plain:.5f} "
                    f"bound_ms={bound:.5f} ({by}) library_ms={lib:.5f} "
                    f"host_ms={host:.5f} floor_ms={floor:.5f} (an empty "
                    f"kernel launched the same way); cluster "
                    f"{geo['cluster']} x {geo['ctas'] // geo['cluster']}, "
                    f"slice {geo['slice']}, {geo['row_tile']} rows a CTA; "
                    f"resources {occ}")
            del seq, h, c, w, rw, b
    log(f"[kernel-lstm] K8 matches its plain version and repeats bit for "
        f"bit: {cases} cases ({len(LSTM_SHAPES)} shapes x 3 dtypes x "
        f"(contiguous, row-strided x), forget_bias {LSTM_FORGET_BIAS}); max "
        f"abs err float32 {err['float32']:.3g} (tolerance {k8.F32_TOL} x "
        f"max(1, |ref|)); 16-bit worst {err['ulp_bfloat16']:.3g} (bfloat16)"
        f", {err['ulp_float16']:.3g} (float16) of the tolerance (1 ulp, or "
        f"the float32 bound near 0)")
    return {"times": times, "shapes": shapes, "max_err": err,
            "cases": cases}


def phase_lstm_serve(k1, k3, k8, pk, env) -> dict:
    from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
    from deeplearning4j_tpu_torch.tools import profile_lstm as pl
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    net = pl.build(seed=0, device="cuda")
    log(f"[lstm-serve] TextGenerationLSTM on cuda: {net.num_params()} "
        f"params (vocab {pl.VOCAB}, 2 x LSTM({pl.UNITS}, "
        f"use_pallas_cell=True), RnnOutputLayer({pl.VOCAB})), "
        f"{time.perf_counter() - t0:.1f} s")
    eng = net.inference_engine()
    rng = np.random.default_rng(9)
    reqs = {n: pl.request(rng, n) for n in pl.REQUESTS}
    t0 = time.perf_counter()
    eng.warmup(pl.REQUESTS, seq_buckets=[pl.SEQ_LEN])
    log(f"[lstm-serve] warmup {list(pl.REQUESTS)} x time bucket "
        f"{LSTM_T_BUCKET}: {time.perf_counter() - t0:.1f} s")

    # ---- the serving path: counts from 0, read after the last request ----
    k1.launches = k1.bwd_launches = k3.launches = 0
    k8.launches = 0
    pk.reset_counters()
    requests = 0
    rows = {}
    for n in pl.REQUESTS:
        x, lengths = reqs[n]
        before = k8.launches
        y = eng.output(x, lengths=lengths)
        requests += 1
        if k8.launches - before != 2 * LSTM_T_BUCKET:
            raise AssertionError(f"request of {n}: {k8.launches - before} K8 "
                                 f"launches, expected {2 * LSTM_T_BUCKET}")
        valid = np.arange(pl.SEQ_LEN)[None, :] < lengths[:, None]
        if y.shape != (n, pl.SEQ_LEN, pl.VOCAB) or not np.isfinite(y).all() \
                or not np.allclose(y.sum(-1)[valid], 1.0, atol=1e-4):
            raise AssertionError(f"request of {n}: bad output {y.shape}")
        before = k8.launches
        row = pl.profile(net, x, lengths)
        requests += row["requests_run"]
        if k8.launches - before != row["requests_run"] * 2 * LSTM_T_BUCKET:
            raise AssertionError(f"request of {n}: {k8.launches - before} K8 "
                                 f"launches in {row['requests_run']} "
                                 f"profiled requests")
        rows[n] = row
        log(f"[lstm-serve] request of {n:2d} x {pl.SEQ_LEN} characters "
            f"(lengths {int(lengths.min())}..{int(lengths.max())}, "
            f"{row['characters']} in all): wall {row['wall_ms_median']:.3f} "
            f"ms (median of 10), {row['sequences_per_s']:.1f} sequences/s, "
            f"{row['characters_per_s']:.0f} characters/s; device "
            f"{row['device_ms']:.3f} ms (busy share "
            f"{row['device_busy_share']:.3f}), K8 {row['k8_device_ms']:.3f} "
            f"ms in {row['k8_launches_per_request']:.0f} launches")
        log("[lstm-serve] top kernels (ms per request): " + "; ".join(
            f"{k[:50]} {t:.3f} x{c}" for k, t, c in row["top_kernels_ms"][:5]))
    serve_launches = k8.launches
    serve_decisions = pk.counters()
    if serve_launches != requests * 2 * LSTM_T_BUCKET \
            or serve_decisions != {"fused": serve_launches,
                                   "fallback_platform": 0}:
        raise AssertionError(f"LSTM serving path: {serve_launches} K8 "
                             f"launches for {requests} requests, decisions "
                             f"{serve_decisions}")

    # ---- greedy generation through rnn_time_step: counts from 0 ----
    k8.launches = 0
    pk.reset_counters()
    prompt = pl.one_hot(rng.integers(0, pl.VOCAB, (pl.STREAMS, pl.PROMPT)))
    outs, ins = pl.generate(net, prompt, pl.GEN_STEPS)
    stream_launches = k8.launches
    want = 2 * (pl.PROMPT + pl.GEN_STEPS)
    if stream_launches != want:
        raise AssertionError(f"generation: {stream_launches} K8 launches, "
                             f"expected {want} (2 per step)")
    gen_ms = statistics.median(pl.generate.step_ms)
    # streaming over the chunks is output() on their concatenation; that
    # output() is a serving request, so its launches and decisions count
    # on the serving path
    before, decided = k8.launches, pk.counters()
    whole = net.output(ins)
    whole_launches = k8.launches - before
    whole_decisions = {k: v - decided[k] for k, v in pk.counters().items()}
    t_whole = 1 << (ins.shape[1] - 1).bit_length()
    if whole_launches != 2 * t_whole or whole_decisions != {
            "fused": whole_launches, "fallback_platform": 0}:
        raise AssertionError(f"output() on the generated text: "
                             f"{whole_launches} K8 launches, decisions "
                             f"{whole_decisions}")
    serve_launches += whole_launches
    e_stream = float(np.abs(outs - whole).max())
    log(f"[lstm-serve] generation: {pl.STREAMS} streams, a {pl.PROMPT}-"
        f"character prompt then {pl.GEN_STEPS} greedy characters through "
        f"rnn_time_step, {stream_launches} K8 launches (2 per step); one "
        f"character {gen_ms:.3f} ms (median), "
        f"{pl.STREAMS * 1e3 / gen_ms:.0f} characters/s; streamed vs "
        f"output() on the {ins.shape[1]} characters: max |diff| "
        f"{e_stream:.3g} (tolerance {LSTM_STREAM_TOL})")
    if not e_stream <= LSTM_STREAM_TOL:
        raise AssertionError("streaming disagrees with output()")
    gen_row = pl.profile_generation(net, prompt, steps=20)
    stream_launches = k8.launches - whole_launches
    stream_decisions = {k: v - whole_decisions[k]
                        for k, v in pk.counters().items()}
    if stream_decisions != {"fused": stream_launches,
                            "fallback_platform": 0} \
            or k1.launches or k1.bwd_launches or k3.launches:
        raise AssertionError(f"LSTM streaming path: decisions "
                             f"{stream_decisions} for {stream_launches} K8 "
                             f"launches; K1/K2/K3 {k1.launches}/"
                             f"{k1.bwd_launches}/{k3.launches}")
    log(f"[lstm-serve] one generated character, profiled: device "
        f"{gen_row['device_ms']:.4f} ms (busy share "
        f"{gen_row['device_busy_share']:.3f}), K8 "
        f"{gen_row['k8_device_ms']:.4f} ms in "
        f"{gen_row['k8_launches_per_step']:.0f} launches")

    # the card against the port's plain path on the CPU, same weights: a
    # batch-2 request, and the 8 streams' text (whose output() the streamed
    # steps matched above)
    x2, l2 = pl.request(np.random.default_rng(10), 2)
    before = k8.launches
    got = eng.output(x2, lengths=l2)
    if k8.launches - before != 2 * LSTM_T_BUCKET:
        raise AssertionError(f"batch-2 request: {k8.launches - before} K8 "
                             f"launches, expected {2 * LSTM_T_BUCKET}")
    serve_launches += k8.launches - before
    cpu = MultiLayerNetwork(net.conf).init(device="cpu")
    cpu.params = {v: {k: t.cpu() for k, t in p.items()}
                  for v, p in net.params.items()}
    ref = cpu.inference_engine().output(x2, lengths=l2)
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    ref8 = cpu.output(ins)
    rel8 = float(np.abs(whole - ref8).max() / np.abs(ref8).max())
    log(f"[lstm-serve] card vs CPU plain path, max|diff|/max|ref|: batch 2 "
        f"{rel:.3g}, the 8 streams' {ins.shape[1]} characters {rel8:.3g} "
        f"(tolerance {LSTM_REL_TOL})")
    if not max(rel, rel8) <= LSTM_REL_TOL:
        raise AssertionError("TextGenerationLSTM on the card disagrees with "
                             "the CPU plain path")

    # a whole-sequence torch.nn.LSTM (cuDNN) on the batch-32 request, as a
    # note for later work; the port never calls it
    x32, _ = reqs[32]
    lstm = torch.nn.LSTM(pl.VOCAB, pl.UNITS, num_layers=2, batch_first=True,
                         device="cuda")
    with torch.no_grad():
        for i in range(2):
            p = net.params[str(i)]
            w_ih, w_hh, b_ih, b_hh = k8.torch_lstm_cell_operands(
                p["W"], p["RW"], p["b"], net.layers[i].forget_bias)
            getattr(lstm, f"weight_ih_l{i}").copy_(w_ih)
            getattr(lstm, f"weight_hh_l{i}").copy_(w_hh)
            getattr(lstm, f"bias_ih_l{i}").copy_(b_ih)
            getattr(lstm, f"bias_hh_l{i}").copy_(b_hh)
        xt = torch.from_numpy(np.concatenate(
            [x32, np.zeros((32, LSTM_T_BUCKET - pl.SEQ_LEN, pl.VOCAB),
                           np.float32)], axis=1)).cuda()
        with env.precision("cuda"):  # TF32 off, as on the path
            cudnn_ms, _ = time_ms(lambda: lstm(xt), reps=10)
    log(f"[lstm-serve] whole-sequence torch.nn.LSTM (2 layers, cuDNN) on the "
        f"batch-32 request padded to {LSTM_T_BUCKET} steps: {cudnn_ms:.3f} ms "
        f"on the device (no mask; a yardstick for later work)")
    return {"serve_launches": serve_launches,
            "stream_launches": stream_launches, "rows": rows,
            "gen_row": gen_row, "gen_ms": gen_ms, "rel_err": rel,
            "rel_err_streams": rel8,
            "stream_err": e_stream, "cudnn_ms": cudnn_ms,
            "requests": requests}


def kernel_launches(kmods) -> dict:
    """Every kernel's launch count (K1, K2, K3, fused K4+K5, K6, K7, K8,
    K9, K10)."""
    k1, k3, k6 = kmods["k1"], kmods["k3"], kmods["k6"]
    return {"k1": k1.launches, "k2": k1.bwd_launches, "k3": k3.launches,
            "k4k5": k3.launches_bwd, "k6": k6.launches,
            "k7": k6.bwd_launches, "k8": kmods["k8"].launches,
            "k9": kmods["k9"].launches, "k10": kmods["k10"].launches}


def zero_launches(kmods) -> None:
    """Every launch counter of the kernel modules to 0, the bfloat16
    ones too."""
    for m in kmods.values():
        for attr in ("launches", "bwd_launches", "launches_bwd",
                     "launches_dq", "launches_dkv", "bf16_launches",
                     "bf16_bwd_launches", "bf16_launches_bwd"):
            if hasattr(m, attr):
                setattr(m, attr, 0)


def phase_lstm_fit(kmods, pk, env) -> dict:
    """TextGenerationLSTM (the serving phase's width, tbptt_length 50)
    trained through ``MultiLayerNetwork.fit``: the first batch's
    gradients against CPU float32/float64 copies and against the CPU's
    full-BPTT gradient; then the main path, with every count set to 0
    just before and read just after: the first steps against the CPU
    plain path, the rest timed, a ``torch.profiler`` split; 0 K8 launches
    in ``fit`` (the gradient path keeps the plain cell); then one batch-32
    ``output`` on the trained weights: 2 x the time bucket K8 launches,
    ``fused`` only, against the CPU plain path."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
    from deeplearning4j_tpu_torch.tools import profile_lstm as pl
    env.Environment.instance().f32_matmul_precision = "highest"
    t_phase = t0 = time.perf_counter()
    batches = pl.markov_text(LSTM_FIT_SEED, pl.FIT_STEPS)
    data_s = time.perf_counter() - t0
    net = pl.build(seed=LSTM_FIT_SEED, device="cuda", tbptt=pl.TBPTT)
    if [getattr(l, "tbptt_length", None) for l in net.layers] != \
            [pl.TBPTT, pl.TBPTT, None]:
        raise AssertionError("the builder did not stamp tbptt_length")

    def cpu_copy(dtype, cast, tbptt=True):
        d = {**json.loads(net.conf.to_json()), "dtype": dtype}
        if not tbptt:
            d["tbptt_length"] = None
            d["layers"] = [{**l, "tbptt_length": None}
                           if "tbptt_length" in l else l
                           for l in d["layers"]]
        m = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            json.dumps(d))).init(device="cpu")
        m.params = {v: {k: cast(t.detach().cpu().clone())
                        for k, t in p.items()}
                    for v, p in net.params.items()}
        return m

    # ---- the first batch's gradients: card, CPU float32/float64/full ----
    x0, y0 = batches[0]
    t0 = time.perf_counter()
    g_card = net._value_and_grad(net._tensor(x0), net._tensor(y0))[1]
    torch.cuda.synchronize()
    cpu = cpu_copy("FLOAT", lambda t: t)
    g32 = cpu._value_and_grad(cpu._tensor(x0), cpu._tensor(y0))[1]
    c64 = cpu_copy("DOUBLE", lambda t: t.double())
    g64 = c64._value_and_grad(c64._tensor(x0), c64._tensor(y0))[1]
    full = cpu_copy("FLOAT", lambda t: t, tbptt=False)
    g_full = full._value_and_grad(full._tensor(x0), full._tensor(y0))[1]
    del c64, full
    worst, bad, trunc = (0.0, "", 0.0, 0.0), [], []
    min_full = math.inf
    for v, leaves in g64.items():
        for k, w64 in leaves.items():
            want = w64.numpy()
            card = g_card[v][k].cpu().numpy()
            e_card = rel_err(card, want)
            e_cpu = rel_err(g32[v][k].numpy(), want)
            allowed = max(TRAIN_GRAD_TOL, GRAD_NOISE_FACTOR * e_cpu)
            if e_card / allowed >= worst[0]:
                worst = (e_card / allowed, f"{v}/{k}", e_card, e_cpu)
            if e_card > allowed:
                bad.append(f"{v}/{k}")
            if "RW" in leaves:  # a recurrent layer: truncation shows
                e_full = rel_err(card, g_full[v][k].numpy())
                min_full = min(min_full, e_full)
                if e_full < LSTM_FIT_TRUNC_FACTOR * allowed:
                    trunc.append(f"{v}/{k}")
    log(f"[lstm-fit] TextGenerationLSTM fit on cuda: {net.num_params()} "
        f"params, tbptt_length {pl.TBPTT}, {pl.FIT_STEPS} batches of "
        f"{pl.FIT_BATCH} x {pl.SEQ_LEN} characters (Markov text made in "
        f"{data_s:.1f} s); first batch's gradients "
        f"({time.perf_counter() - t0:.1f} s): against the CPU float64 gradient the worst card/allowed "
        f"ratio is {worst[0]:.3g} at {worst[1]} (card {worst[2]:.3g}, CPU "
        f"float32 {worst[3]:.3g}; allowed max({TRAIN_GRAD_TOL}, "
        f"{GRAD_NOISE_FACTOR} x CPU float32)); against the CPU's full-BPTT "
        f"gradient the recurrent leaves are at least {min_full:.3g} away "
        f"(at least {LSTM_FIT_TRUNC_FACTOR:g} x allowed)")
    if bad or trunc:
        raise AssertionError(f"LSTM fit gradients on the card: out of bounds "
                             f"{bad}; not the truncated ones {trunc}")
    del g_card, g32, g64, g_full

    # ---- the main path: counts from 0, read after the last fit ----
    zero_launches(kmods)
    pk.reset_counters()
    losses = []
    for x, y in batches[:LSTM_FIT_PARITY_STEPS]:
        ds = DataSet(x, y)
        net.fit(ds)
        cpu.fit(ds)
        losses.append((net.score(), cpu.score()))
    loss_err = max(abs(a - b) / abs(b) for a, b in losses)
    log(f"[lstm-fit] card vs CPU plain path, the first "
        f"{LSTM_FIT_PARITY_STEPS} steps from the same weights: losses "
        + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in losses)
        + f" (worst rel err {loss_err:.3g}, tolerance {LSTM_FIT_LOSS_TOL})")
    if loss_err > LSTM_FIT_LOSS_TOL:
        raise AssertionError("LSTM training on the card disagrees with the "
                             "CPU plain path")
    del cpu
    # one profiled step (after one that starts the tracer): a step runs
    # some 16,000 device kernels, and the profiler is slow to sum them
    row = pl.profile_fit(net, batches[LSTM_FIT_PARITY_STEPS:], reps=1)
    fit_launches = kernel_launches(kmods)
    fit_decisions = pk.counters()
    steps = net.iteration
    all_losses = [a for a, _ in losses] + row["losses"]
    sentinel = net.resilience_counters()
    if any(fit_launches.values()) or any(fit_decisions.values()) or \
            sentinel["bad_total"] or not all(np.isfinite(all_losses)) or \
            not all_losses[-1] <= LSTM_FIT_FALL * all_losses[0]:
        raise AssertionError(f"LSTM fit: launches {fit_launches}, decisions "
                             f"{fit_decisions}, sentinel {sentinel}, losses "
                             f"{all_losses}")
    log(f"[lstm-fit] fit: {steps} steps (the last "
        f"{row['steps']} timed), losses " + " ".join(
            f"{v:.4f}" for v in all_losses)
        + f"; {row['step_wall_ms_median']:.3f} ms a step (median), "
        f"{row['characters_per_s']:.0f} characters/s; device "
        f"{row['device_ms']:.3f} ms a step (busy share "
        f"{row['device_busy_share']:.3f}) in "
        f"{row['device_kernels_per_step']:.0f} device kernels; K8 launches "
        f"in fit "
        f"{fit_launches['k8']} (the gradient path runs the plain cell), "
        f"every other kernel 0; sentinel {sentinel}")
    log("[lstm-fit] top kernels (ms a step): " + "; ".join(
        f"{k[:50]} {t:.3f} x{c}" for k, t, c in row["top_kernels_ms"][:6]))

    # ---- after fit: one batch-32 request on the trained weights ----
    zero_launches(kmods)
    pk.reset_counters()
    x32 = batches[0][0]
    got = net.output(x32)
    out_launches = kernel_launches(kmods)
    out_decisions = pk.counters()
    bucket = 1 << (pl.SEQ_LEN - 1).bit_length()
    if out_launches != {**{k: 0 for k in out_launches}, "k8": 2 * bucket} \
            or out_decisions != {"fused": 2 * bucket,
                                 "fallback_platform": 0}:
        raise AssertionError(f"output() after fit: launches {out_launches}, "
                             f"decisions {out_decisions}")
    ref_net = MultiLayerNetwork(net.conf).init(device="cpu")
    ref_net.params = {v: {k: t.detach().cpu() for k, t in p.items()}
                      for v, p in net.params.items()}
    ref = ref_net.output(x32)
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    log(f"[lstm-fit] output() of the trained net on a batch-32 request: "
        f"{out_launches['k8']} K8 launches (2 x time bucket {bucket}), "
        f"decisions {out_decisions}; card vs CPU plain path max|diff|/"
        f"max|ref| {rel:.3g} (tolerance {LSTM_FIT_OUT_TOL})")
    log(f"[lstm-fit] {smi_line()}; phase {time.perf_counter() - t_phase:.1f}"
        " s")
    if not rel <= LSTM_FIT_OUT_TOL:
        raise AssertionError("the trained TextGenerationLSTM on the card "
                             "disagrees with the CPU plain path")
    return {"fit_launches": fit_launches,
            "output_launches": out_launches, "row": row,
            "steps": steps, "losses": all_losses, "loss_rel_err": loss_err,
            "grad_worst_ratio": worst[0], "full_bptt_min_rel": min_full,
            "output_rel_err": rel}


def breadth_cases():
    """``(name, layer, x maker, masked)`` for [rnn-breadth]: every layer
    kind of the recurrent-family slice at a small size."""
    from deeplearning4j_tpu_torch.nn.layers import (
        GRU, LSTM, Bidirectional, ConvLSTM2D, DenseLayer, EmbeddingLayer,
        EmbeddingSequenceLayer, GravesLSTM, MaskingLayer, MaskLayer,
        RecurrentAttentionLayer, RepeatVector, SimpleRnn, TimeDistributed)
    B, T, F, U = BREADTH_B, BREADTH_T, BREADTH_F, BREADTH_U

    def seq(g):
        return torch.randn((B, T, F), generator=g)

    def ids(shape):
        return lambda g: torch.randint(0, F, shape, generator=g).float()

    def zero_steps(g):
        x = seq(g)
        x[0, 5] = 0.0
        x[2] = 0.0
        return x

    cases = [("GravesLSTM", GravesLSTM(n_out=U), seq, True),
             ("GRU reset_after", GRU(n_out=U), seq, True),
             ("GRU classic", GRU(n_out=U, reset_after=False), seq, True),
             ("SimpleRnn", SimpleRnn(n_out=U), seq, True)]
    for mode in ("concat", "add", "mul", "average"):
        for rs in (True, False):
            cases.append((f"Bidirectional {mode} return_sequences={rs}",
                          Bidirectional(layer=LSTM(n_out=U), mode=mode,
                                        return_sequences=rs), seq, True))
    cases += [
        ("ConvLSTM2D", ConvLSTM2D(n_out=8),
         lambda g: torch.randn((B, 6, 8, 8, 3), generator=g), True),
        ("ConvLSTM2D return_sequences=False",
         ConvLSTM2D(n_out=8, stride=(2, 2), return_sequences=False),
         lambda g: torch.randn((B, 6, 8, 8, 3), generator=g), True),
        ("RecurrentAttentionLayer", RecurrentAttentionLayer(n_out=U), seq,
         True),
        ("TimeDistributed", TimeDistributed(layer=DenseLayer(
            n_out=U, activation="tanh")), seq, True),
        ("RepeatVector", RepeatVector(n=T),
         lambda g: torch.randn((B, F), generator=g), False),
        ("MaskLayer", MaskLayer(), seq, True),
        ("MaskingLayer", MaskingLayer(), zero_steps, True),
        ("EmbeddingLayer", EmbeddingLayer(n_in=F, n_out=U), ids((B, 1)),
         False),
        ("EmbeddingSequenceLayer", EmbeddingSequenceLayer(n_in=F, n_out=U),
         ids((B, T, 1)), True)]
    return cases


def phase_rnn_breadth(kmods, pk, env) -> dict:
    """Each new recurrent-family layer at a small size: one forward (with
    a ragged mask and a fully masked row where the layer takes a mask) and
    one backward of ``sum(y * cot)`` on the card against the CPU plain run
    on the same weights; then ``output`` of a MultiLayerNetwork with a
    ``Bidirectional(LSTM(use_pallas_cell=True))``: 0 K8 launches (the
    JAX package's Bidirectional never asks for the forward-only cell)."""
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import (LSTM, Bidirectional,
                                                    RnnOutputLayer)
    from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils import tree
    env.Environment.instance().f32_matmul_precision = "highest"
    zero_launches(kmods)
    pk.reset_counters()
    t0 = time.perf_counter()
    worst = {}
    for name, layer, make_x, masked in breadth_cases():
        g = torch.Generator().manual_seed(len(worst))
        x = make_x(g)
        mask = None
        if masked:
            lengths = torch.tensor([x.shape[1], x.shape[1] // 2, 0, 1])
            mask = (torch.arange(x.shape[1])[None, :]
                    < lengths[:, None]).float()
        p, _, _ = layer.initialize(g, tuple(x.shape[1:]), torch.float32,
                                   "cpu")
        out = {}
        for dev in ("cpu", "cuda"):
            pd = tree.tmap(
                lambda t: t.detach().to(dev).requires_grad_(True), p)
            xd = x.to(dev).requires_grad_(not name.startswith("Embed"))
            with env.precision(dev):
                y, _, _ = layer.apply(pd, xd, {}, train=True,
                                      mask=None if mask is None
                                      else mask.to(dev))
                cot = torch.randn(y.shape, generator=torch.Generator()
                                  .manual_seed(7)).to(dev)
                leaves = list(tree.leaves(pd)) + (
                    [xd] if xd.requires_grad else [])
                grads = torch.autograd.grad((y * cot).sum(), leaves)
            out[dev] = [y.detach().cpu()] + [gr.cpu() for gr in grads]
        worst[name] = max(float((a - b).abs().max() / b.abs().max().clamp(
            min=1e-30)) for a, b in zip(out["cuda"], out["cpu"]))
    # a Bidirectional LSTM net's output(): the plain cell on the card
    conf = (NeuralNetConfiguration.builder().seed(1)
            .input_type(InputType.recurrent(BREADTH_F))
            .list(Bidirectional(layer=LSTM(n_out=BREADTH_U,
                                           use_pallas_cell=True)),
                  RnnOutputLayer(n_out=BREADTH_F)).build())
    net = MultiLayerNetwork(conf).init(device="cuda")
    cpu = MultiLayerNetwork(conf).init(device="cpu")
    cpu.params = tree.tmap(lambda t: t.cpu(), net.params)
    xb = np.random.default_rng(3).standard_normal(
        (BREADTH_B, BREADTH_T, BREADTH_F)).astype(np.float32)
    got = net.output(xb)
    ref = cpu.output(xb)
    worst["Bidirectional(LSTM(use_pallas_cell=True)) output()"] = float(
        np.abs(got - ref).max() / np.abs(ref).max())
    launches = kernel_launches(kmods)
    decisions = pk.counters()
    log(f"[rnn-breadth] {len(worst)} cases in "
        f"{time.perf_counter() - t0:.1f} s, card vs CPU plain run, worst "
        f"max|diff|/max|ref| over the output and every gradient "
        f"(tolerance {BREADTH_TOL}): " + "; ".join(
            f"{k} {v:.3g}" for k, v in worst.items()))
    log(f"[rnn-breadth] launches {launches}, K8 decisions {decisions} (a "
        f"Bidirectional never asks for the fused cell)")
    bad = [k for k, v in worst.items() if not v <= BREADTH_TOL]
    if bad or any(launches.values()) or decisions["fused"]:
        raise AssertionError(f"[rnn-breadth] out of bounds: {bad}; "
                             f"launches {launches}, decisions {decisions}")
    return {"worst": worst, "launches": launches}


def one_kernel_a_call(kernel: str, shapes, name: str) -> dict:
    """Hold one call of ``kernel``'s wrapper at each of ``shapes`` in each
    dtype to one device kernel, ``name``, as ``torch.profiler`` records it
    in a fresh process (``tools/count_kernels.py`` says why); returns
    ``{split count: kernels a call}``."""
    from deeplearning4j_tpu_torch.tools import count_kernels
    per_split = {}
    for _, shape, dtype, splits, names in count_kernels.count_in_subprocess(
            [[kernel, list(s), dt] for s in shapes
             for dt in ("float32", "bfloat16", "float16")]):
        if len(names) != 1 or name not in names[0]:
            raise AssertionError(f"{kernel} {dtype} {tuple(shape)}: one call "
                                 f"launched {names}, not one {name}")
        per_split[splits] = len(names)
    return per_split


def phase_kernel_decode(k9, path_lengths) -> dict:
    """K9 against its plain version at DECODE_SHAPES x 3 dtypes x (packed,
    head-split q), twice per case for determinism, one kernel a call at
    every shape and dtype (``torch.profiler``); returns the float32 times at
    the path's shape (``path_lengths``, the lengths of a decode step
    halfway through the bench's mix) and at the long one, with an empty
    kernel launched as K9 is beside them, and the errors."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    neg = float(torch.finfo(torch.float32).min)
    err = {"float32": 0.0, "tol_share_bfloat16": 0.0,
           "tol_share_float16": 0.0}
    times, floors, cases = {}, {}, 0
    for B, H, C, d in DECODE_SHAPES:
        ln = torch.randint(1, C + 1, (B,), generator=gen, device=dev)
        ln[0], ln[1] = 1, C
        if B > 2:
            ln[2] = 0  # an inactive slot: uniform weights over the cache
        ln = ln.to(torch.int32)
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            k, v = (attn_operand(B, H, C, d, dtype, "packed", gen)
                    for _ in range(2))
            for layout in ATTN_LAYOUTS:
                q = attn_operand(B, H, 1, d, dtype, layout, gen)
                got = k9.decode_attention(q, k, v, ln)
                again = k9.decode_attention(q, k, v, ln)
                torch.cuda.synchronize()
                where = f"K9 {str(dtype)[6:]} {(B, H, C, d)} {layout}"
                if not torch.equal(got, again):
                    raise AssertionError(f"{where} is not deterministic")
                ref = k9.decode_attention_reference(q, k, v, ln)
                viol = k9.max_violation(got, ref, q, k, v, ln)
                if dtype == torch.float32:
                    err["float32"] = max(err["float32"], float(
                        (got - ref).abs().max()))
                else:
                    key = "tol_share_" + str(dtype)[6:]
                    err[key] = max(err[key], viol)
                if viol > 1.0:
                    raise AssertionError(f"{where} disagrees with its plain "
                                         f"version: {viol:.3g} x the "
                                         "tolerance")
                cases += 1
                if (B, H, C, d) == DECODE_LONG_SHAPE and layout == "packed" \
                        and dtype == torch.bfloat16:
                    power = tolerance_power(k9, q, k, v, ln, ref)
            if (B, H, C, d) not in (DECODE_PATH_SHAPE, DECODE_LONG_SHAPE) \
                    or dtype == torch.float16:
                continue
            if (B, H, C, d) == DECODE_PATH_SHAPE:
                tl = torch.tensor(path_lengths, dtype=torch.int32,
                                  device=dev)
            else:
                tl = torch.randint(C // 2, C + 1, (B,), generator=gen,
                                   device=dev).to(torch.int32)
            mask = torch.where(torch.arange(C, device=dev)[None, :]
                               < tl[:, None], 0.0, neg)[:, None, None, :]
            ms, host = time_ms(lambda: k9.decode_attention(q, k, v, tl))
            plain, _ = time_ms(
                lambda: k9.decode_attention_reference(q, k, v, tl), reps=10)
            lib, _ = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask.to(dtype)))
            bound, by = k9.bound_ms(tl.cpu().numpy(), H, C, d,
                                    q.element_size())
            # the same launch with an empty kernel: what any launch costs
            # under this timing
            floor, _ = time_ms(lambda: k9.launch_floor(B, H, C, d, dtype))
            if dtype == torch.float32:
                times[(B, H, C, d)] = (ms, plain, lib, host, bound, by)
                floors[(B, H, C, d)] = floor
            log(f"[kernel-decode] K9 {str(dtype)[6:]:8s} B={B:2d} H={H:2d} "
                f"C={C:4d} d={d:3d} heads splits={k9.num_splits(B, H, C)} "
                f"threads={k9.cta_threads(B, H, C)} lengths "
                f"{int(tl.min())}..{int(tl.max())} ms={ms:.5f} "
                f"plain_ms={plain:.5f} bound_ms={bound:.5f} ({by}) "
                f"library_ms={lib:.5f} host_ms={host:.5f} "
                f"floor_ms={floor:.5f} (an empty kernel launched the same "
                f"way)")
            del q, k, v
    log(f"[kernel-decode] K9 matches its plain version and repeats bit for "
        f"bit: {cases} cases ({len(DECODE_SHAPES)} shapes x 3 dtypes x "
        f"{len(ATTN_LAYOUTS)} q layouts; lengths with 1, C and 0); max abs "
        f"err float32 {err['float32']:.3g} (tolerance {k9.F32_TOL} x max(1,"
        f" |ref|)); 16-bit worst {err['tol_share_bfloat16']:.3g} (bfloat16)"
        f", {err['tol_share_float16']:.3g} (float16) of the tolerance (4 u "
        f"(sum p|v|/l + |o|))")
    log(f"[kernel-decode] the bfloat16 tolerance rejects a kernel that "
        f"drops one split's keys at {DECODE_LONG_SHAPE}: "
        f"{power['rejected']} of {power['rows']} (b, h, dropped split) rows"
        f", the least {power['min_violation']:.3g} x the tolerance")
    per_split = one_kernel_a_call("K9", DECODE_SHAPES, "decode_attn_kernel")
    log(f"[kernel-decode] kernels one call launches (torch.profiler, "
        f"{len(DECODE_SHAPES)} shapes x 3 dtypes), by split count: "
        f"{dict(sorted(per_split.items()))}")
    return {"times": times, "floors": floors, "per_split": per_split,
            "max_err": err, "cases": cases, "power": power}


def tolerance_power(k9, q, k, v, ln, ref) -> dict:
    """Hold ``k9.dropped_split_reference`` for each split against the
    plain version: the tolerance must reject it in every (b, h) row whose
    dropped split held some but not all of its keys."""
    rows = rejected = 0
    least = math.inf
    tol = k9.tolerance(ref, q, k, v, ln)
    for which in range(k9.num_splits(*k.shape[:3])):
        bad, partial = k9.dropped_split_reference(q, k, v, ln, which)
        viol = ((bad.double() - ref.double()).abs() / tol).amax((2, 3))
        viol = viol[partial]
        rows += viol.numel()
        rejected += int((viol > 1.0).sum())
        if viol.numel():
            least = min(least, float(viol.min()))
    if rows == 0 or rejected != rows:
        raise AssertionError(f"the K9 tolerance rejects a dropped split in "
                             f"{rejected} of {rows} rows")
    return {"rows": rows, "rejected": rejected, "min_violation": least}


def generate_path(cb, mix, runs, counters) -> dict:
    """Serve ``mix`` ``runs`` times plus a profiled run through ``cb`` with
    every launch count and decision counter at 0 just before, and check
    them just after: 3 K3 launches per prefill and 3 K9 launches per
    decode step (as the engine counts them), ``fused`` and
    ``decode_fused`` decisions only, no other kernel."""
    from deeplearning4j_tpu_torch.tools import profile_generate as pg
    k1, k3, k8, k9, k10, fa, pk = counters
    eng = cb.engine
    k1.launches = k1.bwd_launches = k3.launches = k8.launches = 0
    k9.launches = k10.launches = 0
    fa.reset_counters()
    pk.reset_counters()
    p0, d0 = eng.prefill_runs, eng.decode_steps
    row = pg.profile(cb, mix, runs=runs)
    torch.cuda.synchronize()
    prefills, steps = eng.prefill_runs - p0, eng.decode_steps - d0
    launches = {"k3": k3.launches, "k9": k9.launches, "k10": k10.launches}
    want_dec = {k: 0 for k in fa.decode_counters()}
    want_dec["decode_fused"] = k9.launches
    want_att = {k: 0 for k in fa.counters()}
    want_att["fused"] = k3.launches
    if k3.launches != GEN_LAYERS * prefills \
            or k9.launches != GEN_LAYERS * steps or steps == 0 \
            or fa.decode_counters() != want_dec \
            or fa.counters() != want_att \
            or k1.launches or k1.bwd_launches or k8.launches \
            or k10.launches or row["dispatch_decisions"]["host_loop"]:
        raise AssertionError(
            f"generative path: {k3.launches} K3 launches for {prefills} "
            f"prefills, {k9.launches} K9 launches for {steps} decode steps, "
            f"decisions {fa.counters()} {fa.decode_counters()} "
            f"{row['dispatch_decisions']}, K1/K2/K8 {k1.launches}/"
            f"{k1.bwd_launches}/{k8.launches}")
    row.update(prefills=prefills, decode_steps=steps, launches=launches)
    return row


def check_streams(cpu, mix, row, n, tag, phase="generate") -> dict:
    """The first ``n`` streams teacher-forced through the CPU plain path
    (``profile_generate.teacher_forced``); raises on a violation."""
    from deeplearning4j_tpu_torch.tools import profile_generate as pg
    worst = {"violations": 0, "near_ties": 0, "min_gap": float("inf"),
             "last_rel_err": 0.0}
    for i in range(n):
        tf = pg.teacher_forced(cpu, mix[i], row["streams"][i],
                               row["last_logits"][i])
        worst["violations"] += tf["violations"]
        worst["near_ties"] += tf["near_ties"]
        worst["min_gap"] = min(worst["min_gap"], tf["min_gap"])
        worst["last_rel_err"] = max(worst["last_rel_err"],
                                    tf["last_rel_err"])
    log(f"[{phase}] {tag}: {n} streams teacher-forced through the CPU plain "
        f"path: {worst['violations']} tokens off the CPU's argmax, "
        f"{worst['near_ties']} steps with a top-2 gap below "
        f"{pg.TIE_TOL} of the top (smallest gap {worst['min_gap']:.3g}); "
        f"last-step probabilities {worst['last_rel_err']:.3g} (tolerance "
        f"{GEN_REL_TOL})")
    if worst["violations"] or not worst["last_rel_err"] <= GEN_REL_TOL:
        raise AssertionError(f"{tag}: the card's streams disagree with the "
                             "CPU plain path")
    return worst


def log_generate_row(tag, row) -> None:
    log(f"[generate] {tag}: {row['requests']} requests x {row['slots']} "
        f"slots, prompts {row['prompt_tokens'][0]}-"
        f"{row['prompt_tokens'][1]} tokens, {row['new_tokens']} new tokens: "
        f"wall {row['wall_ms_median']:.3f} ms (median of "
        f"{len(row['walls_ms'])}), {row['tokens_per_s']:.1f} tokens/s, TTFT "
        f"p50/p99 {row['ttft_ms_p50']:.3f}/{row['ttft_ms_p99']:.3f} ms, "
        f"TPOT p50/p99 {row['tpot_ms_p50']:.3f}/{row['tpot_ms_p99']:.3f} ms;"
        f" {row['decode_steps_per_run']:.1f} decode steps per run; cache "
        f"{row['final_cache_len']}; device {row['device_ms']} ms (busy share"
        f" {row['device_busy_share']}), K9 {row['k9_device_ms']} ms, K3 "
        f"{row['k3_device_ms']} ms")
    log(f"[generate] {tag} top kernels (ms per run): " + "; ".join(
        f"{k[:50]} {t:.3f} x{c}" for k, t, c in row["top_kernels_ms"][:6]))


def phase_generate(counters, env) -> dict:
    from deeplearning4j_tpu_torch.serving.batcher import ContinuousBatcher
    from deeplearning4j_tpu_torch.tools import profile_generate as pg
    k1, k3, k8, k9, k10, fa, pk = counters
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    net = pg.build(seed=0, device="cuda")
    cpu = pg.cpu_copy(net)
    log(f"[generate] the bench's generative model on cuda: "
        f"{net.num_params()} params (V {pg.VOCAB}, 3 x SelfAttentionLayer("
        f"{pg.VOCAB}, {pg.HEADS} heads)), {time.perf_counter() - t0:.1f} s")

    # output() on a ragged batch-2 request against the CPU plain path
    rng = np.random.default_rng(12)
    x2 = np.eye(pg.VOCAB, dtype=np.float32)[rng.integers(0, pg.VOCAB,
                                                         (2, 64))]
    l2 = np.array([64, 37])
    k3.launches = k9.launches = 0
    fa.reset_counters()
    got = net.inference_engine().output(x2, lengths=l2)
    out_launches = (k3.launches, k9.launches)
    if out_launches != (GEN_LAYERS, 0) \
            or fa.counters()["fused"] != GEN_LAYERS \
            or sum(fa.counters().values()) != GEN_LAYERS \
            or any(fa.decode_counters().values()):
        raise AssertionError(f"output(): {out_launches} K3, K9 launches, "
                             f"decisions {fa.counters()} "
                             f"{fa.decode_counters()}")
    ref = cpu.inference_engine().output(x2, lengths=l2)
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    log(f"[generate] output() on 2 x 64 tokens (lengths 64, 37): "
        f"{out_launches[0]} K3 launches, no K9; card vs CPU plain path "
        f"max|diff|/max|ref| {rel:.3g} (tolerance {GEN_REL_TOL})")
    if not rel <= GEN_REL_TOL:
        raise AssertionError("output() on the card disagrees with the CPU")

    # greedy sampling on the card: the first maximum on ties, as the host
    # oracle np.argmax takes it
    from deeplearning4j_tpu_torch.ops import sampling as smp
    ties = np.random.default_rng(13).standard_normal((64, pg.VOCAB)).astype(
        np.float32)
    ties[::2, 7] = ties[::2, 200] = ties[::2, 90] = 50.0
    got_t = smp.greedy(torch.from_numpy(ties).cuda()).cpu().numpy()
    if not np.array_equal(got_t, np.argmax(ties, -1)) \
            or not (got_t[::2] == 7).all():
        raise AssertionError("greedy on the card does not take the first "
                             "maximum")
    log("[generate] greedy on the card equals np.argmax on 64 rows of 256 "
        "logits, ties included (the first maximum wins)")

    rows, streams = {}, {}
    for tag, kw, mix_spec, runs, checked in (
            ("bench", pg.BENCH, pg.BENCH_PROMPTS, 3, pg.BENCH_PROMPTS[0]),
            ("grow", pg.GROW, pg.GROW_PROMPTS, 2, GROW_CHECKED)):
        t0 = time.perf_counter()
        cb = ContinuousBatcher(net, **kw)
        log(f"[generate] {tag}: ContinuousBatcher({kw}) built and warmed in "
            f"{time.perf_counter() - t0:.1f} s; cache "
            f"{cb.stats()['cache_len']}")
        mix = pg.prompts(*mix_spec)
        try:
            row = generate_path(cb, mix, runs, counters)
        finally:
            cb.shutdown()
        log_generate_row(tag, row)
        row["check"] = check_streams(cpu, mix, row, checked, tag)
        if tag == "grow" and row["final_cache_len"] != kw["max_cache_len"]:
            raise AssertionError(f"the growth mix ended at cache "
                                 f"{row['final_cache_len']}")
        streams[tag] = row.pop("streams")
        del row["last_logits"]
        rows[tag] = row
    return {"net": net, "cpu": cpu, "rows": rows, "streams": streams,
            "output_rel_err": rel, "output_launches": out_launches}


def phase_generate_server(counters, server_mod, net) -> dict:
    from deeplearning4j_tpu_torch.tools import profile_generate as pg
    k1, k3, k8, k9, k10, fa, pk = counters
    srv = server_mod.JsonModelServer(
        net, generate=dict(pg.BENCH, max_new_tokens=SERVER_NEW))
    port = srv.start()
    eng = srv.generator.engine
    k3.launches = k9.launches = k10.launches = 0
    fa.reset_counters()
    p0, d0 = eng.prefill_runs, eng.decode_steps
    try:
        for i, p in enumerate(pg.prompts(*pg.BENCH_PROMPTS)[:3]):
            tokens = [int(t) for t in p.argmax(-1)]
            body = json.dumps({"tokens": tokens, "stream": True}).encode()
            with urllib.request.urlopen(urllib.request.Request(
                    f"http://127.0.0.1:{port}/generate", data=body),
                    timeout=120) as r:
                lines = [json.loads(x) for x in r.read().decode().splitlines()
                         if x]
            want = srv.generator.generate(tokens=tokens)["tokens"]
            streamed = [x.get("token") for x in lines[:-1]]
            if not lines[-1].get("done") or streamed != want \
                    or lines[-1]["tokens"] != want or len(want) != SERVER_NEW:
                raise AssertionError(f"POST /generate {i}: {lines[-1]} vs "
                                     f"{want}")
        torch.cuda.synchronize()
    finally:
        srv.stop()
    prefills, steps = eng.prefill_runs - p0, eng.decode_steps - d0
    if k3.launches != GEN_LAYERS * prefills \
            or k9.launches != GEN_LAYERS * steps or k10.launches \
            or fa.decode_counters()["decode_fused"] != k9.launches \
            or sum(fa.decode_counters().values()) != k9.launches:
        raise AssertionError(f"generative server: {k3.launches} K3 / "
                             f"{k9.launches} K9 launches for {prefills} "
                             f"prefills / {steps} steps, decisions "
                             f"{fa.decode_counters()}")
    log(f"[generate-server] POST /generate on localhost for 3 prompts: each "
        f"NDJSON stream ({SERVER_NEW} tokens) equals batcher.generate; "
        f"{k3.launches} K3 launches for {prefills} prefills, {k9.launches} "
        f"K9 launches for {steps} decode steps")
    return {"launches": {"k3": k3.launches, "k9": k9.launches, "k10": 0}}


def window_mask_bias(k10, ln, n_queries: int, C: int, dtype):
    """The float ``[B, 1, k, C]`` window mask of ``ln`` (0 where a query
    may attend, ``finfo(float32).min`` elsewhere; a fully masked query
    takes the uniform rule through its all-min row), for
    ``scaled_dot_product_attention``."""
    keep, uniform = k10.window_mask(ln, n_queries, C)
    neg = float(torch.finfo(torch.float32).min)
    bias = torch.where(keep | uniform[:, :, None], 0.0, neg)
    return bias[:, None].to(dtype)


def phase_kernel_mq(k10, k9, path_lengths) -> dict:
    """K10 against its plain version at MQ_SHAPES x 3 dtypes x (packed,
    head-split q), twice per case for determinism, one kernel a call at
    every shape and dtype (``torch.profiler``); ``path_lengths`` maps a timed
    shape to the lengths (before the window) of a verify step halfway
    through its mix. Returns the float32 times with an empty kernel
    launched as K10 is beside them, the errors and the bfloat16
    dropped-split check."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    err = {"float32": 0.0, "tol_share_bfloat16": 0.0,
           "tol_share_float16": 0.0}
    times, floors, cases, power = {}, {}, 0, None
    for B, H, kq, C, d in MQ_SHAPES:
        ln = torch.randint(0, C - kq + 1, (B,), generator=gen, device=dev)
        ln[0], ln[1] = 0, C - kq
        if B > 2:
            ln[2] = -kq  # every query of this row fully masked: uniform
        ln = ln.to(torch.int32)
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            k, v = (attn_operand(B, H, C, d, dtype, "packed", gen)
                    for _ in range(2))
            for layout in ATTN_LAYOUTS:
                q = attn_operand(B, H, kq, d, dtype, layout, gen)
                got = k10.multiquery_decode(q, k, v, ln)
                again = k10.multiquery_decode(q, k, v, ln)
                torch.cuda.synchronize()
                where = f"K10 {str(dtype)[6:]} {(B, H, kq, C, d)} {layout}"
                if not torch.equal(got, again):
                    raise AssertionError(f"{where} is not deterministic")
                ref = k10.multiquery_decode_reference(q, k, v, ln)
                viol = k10.max_violation(got, ref, q, k, v, ln)
                if dtype == torch.float32:
                    err["float32"] = max(err["float32"], float(
                        (got - ref).abs().max()))
                else:
                    key = "tol_share_" + str(dtype)[6:]
                    err[key] = max(err[key], viol)
                if viol > 1.0:
                    raise AssertionError(f"{where} disagrees with its plain "
                                         f"version: {viol:.3g} x the "
                                         "tolerance")
                cases += 1
                if (B, H, kq, C, d) == MQ_LONG_SHAPE and layout == "packed" \
                        and dtype == torch.bfloat16:
                    power = mq_tolerance_power(k10, k9, q, k, v, ln, ref)
            shape = (B, H, kq, C, d)
            if shape not in MQ_TIMED or dtype == torch.float16:
                continue
            if shape in path_lengths:
                tl = torch.tensor(path_lengths[shape], dtype=torch.int32,
                                  device=dev)
            else:
                tl = torch.randint(C // 2, C - kq + 1, (B,), generator=gen,
                                   device=dev).to(torch.int32)
            mask = window_mask_bias(k10, tl, kq, C, dtype)
            ms, host = time_ms(lambda: k10.multiquery_decode(q, k, v, tl))
            plain, _ = time_ms(
                lambda: k10.multiquery_decode_reference(q, k, v, tl),
                reps=10)
            lib, _ = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask))
            bound, by = k10.bound_ms(tl.cpu().numpy(), H, kq, C, d,
                                     q.element_size())
            floor, _ = time_ms(
                lambda: k10.launch_floor(B, H, kq, C, d, dtype))
            if dtype == torch.float32:
                times[shape] = (ms, plain, lib, host, bound, by)
                floors[shape] = floor
            log(f"[kernel-mq-decode] K10 {str(dtype)[6:]:8s} B={B:2d} "
                f"H={H:2d} k={kq} C={C:4d} d={d:3d} heads splits="
                f"{k9.num_splits(B, H, C)} smem="
                f"{k10.smem_bytes(B, H, kq, C, d, dtype)} lengths "
                f"{int(tl.min())}..{int(tl.max())} ms={ms:.5f} "
                f"plain_ms={plain:.5f} bound_ms={bound:.5f} ({by}) "
                f"library_ms={lib:.5f} host_ms={host:.5f} "
                f"floor_ms={floor:.5f} (an empty kernel launched the same "
                f"way)")
            del q, k, v
    log(f"[kernel-mq-decode] K10 matches its plain version and repeats bit "
        f"for bit: {cases} cases ({len(MQ_SHAPES)} shapes x 3 dtypes x "
        f"{len(ATTN_LAYOUTS)} q layouts; lengths with 0, C - k and a fully "
        f"masked row); max abs err float32 {err['float32']:.3g} (tolerance "
        f"{k10.F32_TOL} x max(1, |ref|)); 16-bit worst "
        f"{err['tol_share_bfloat16']:.3g} (bfloat16), "
        f"{err['tol_share_float16']:.3g} (float16) of the tolerance (4 u "
        f"(sum p|v|/l + |o|) per query row)")
    log(f"[kernel-mq-decode] the bfloat16 tolerance rejects a kernel that "
        f"drops one split's keys at {MQ_LONG_SHAPE}: {power['rejected']} of "
        f"{power['rows']} (b, h, query, dropped split) rows, the least "
        f"{power['min_violation']:.3g} x the tolerance")
    per_split = one_kernel_a_call("K10", MQ_SHAPES, "mq_decode_kernel")
    log(f"[kernel-mq-decode] kernels one call launches (torch.profiler, "
        f"{len(MQ_SHAPES)} shapes x 3 dtypes), by split count: "
        f"{dict(sorted(per_split.items()))}")
    return {"times": times, "floors": floors, "per_split": per_split,
            "max_err": err, "cases": cases, "power": power}


def mq_tolerance_power(k10, k9, q, k, v, ln, ref) -> dict:
    """Hold ``k10.dropped_split_reference`` for each split against the
    plain version: the tolerance must reject it in every (b, h, query) row
    whose window held some but not all of the dropped keys."""
    rows = rejected = 0
    least = math.inf
    tol = k10.tolerance(ref, q, k, v, ln)
    B, H, kq, _ = q.shape
    for which in range(k9.num_splits(B, H, k.shape[2])):
        bad, partial = k10.dropped_split_reference(q, k, v, ln, which)
        viol = ((bad.double() - ref.double()).abs() / tol).amax(-1)
        viol = viol[partial[:, None, :].expand(B, H, kq)]
        rows += viol.numel()
        rejected += int((viol > 1.0).sum())
        if viol.numel():
            least = min(least, float(viol.min()))
    if rows == 0 or rejected != rows:
        raise AssertionError(f"the K10 tolerance rejects a dropped split in "
                             f"{rejected} of {rows} rows")
    return {"rows": rows, "rejected": rejected, "min_violation": least}


def spec_path(cb, mix, runs, counters) -> dict:
    """Serve ``mix`` through a paged (and maybe speculative) ``cb`` as
    ``generate_path`` does, with every count at 0 just before and checked
    just after: 3 K3 launches per prefill (the target's misses and the
    draft's), 3 K9 launches per single-token step (the target's and the
    draft's), 3 K10 launches per verify step; decisions ``fused``,
    ``decode_fused`` and ``decode_multiquery`` only."""
    from deeplearning4j_tpu_torch.tools import profile_generate as pg
    k1, k3, k8, k9, k10, fa, pk = counters
    eng, draft = cb.engine, cb.draft
    k1.launches = k1.bwd_launches = k3.launches = k8.launches = 0
    k9.launches = k10.launches = 0
    fa.reset_counters()
    pk.reset_counters()
    before = (eng.prefill_runs, eng.decode_steps, eng.verify_steps,
              draft.prefill_runs if draft else 0,
              draft.decode_steps if draft else 0)
    row = pg.profile(cb, mix, runs=runs)
    torch.cuda.synchronize()
    after = (eng.prefill_runs, eng.decode_steps, eng.verify_steps,
             draft.prefill_runs if draft else 0,
             draft.decode_steps if draft else 0)
    prefills, steps, verify, dprefills, dsteps = (
        a - b for a, b in zip(after, before))
    launches = {"k3": k3.launches, "k9": k9.launches, "k10": k10.launches}
    want_dec = {k: 0 for k in fa.decode_counters()}
    want_dec["decode_fused"] = k9.launches
    want_dec["decode_multiquery"] = k10.launches
    want_att = {k: 0 for k in fa.counters()}
    want_att["fused"] = k3.launches
    if k3.launches != GEN_LAYERS * (prefills + dprefills) \
            or k9.launches != GEN_LAYERS * (steps + dsteps) \
            or k10.launches != GEN_LAYERS * verify \
            or (draft is not None) != (verify > 0 and dsteps > 0) \
            or (draft is None and steps == 0) \
            or fa.decode_counters() != want_dec \
            or fa.counters() != want_att \
            or k1.launches or k1.bwd_launches or k8.launches \
            or row["dispatch_decisions"]["host_loop"]:
        raise AssertionError(
            f"paged path: {k3.launches} K3 launches for {prefills} + "
            f"{dprefills} prefills, {k9.launches} K9 launches for {steps} + "
            f"{dsteps} decode steps, {k10.launches} K10 launches for "
            f"{verify} verify steps, decisions {fa.counters()} "
            f"{fa.decode_counters()} {row['dispatch_decisions']}, K1/K2/K8 "
            f"{k1.launches}/{k1.bwd_launches}/{k8.launches}")
    row.update(prefills=prefills, decode_steps=steps, verify_steps=verify,
               draft_prefills=dprefills, draft_steps=dsteps,
               launches=launches)
    return row


def split_gap(cpu, prompt, ours, theirs):
    """None when two card streams of ``prompt`` are equal; else the CPU
    plain path's top-2 gap (share of the top probability) at the first
    position they part, teacher-forced on their common prefix."""
    from deeplearning4j_tpu_torch.tools import profile_generate as pg
    if ours == theirs:
        return None
    j = next((i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b),
             min(len(ours), len(theirs)))
    eye = np.eye(pg.VOCAB, dtype=np.float32)
    seq = np.concatenate([prompt, eye[np.asarray(ours[:j], np.int64)]])
    with torch.inference_mode():
        y = cpu._full_context(cpu.params, torch.from_numpy(seq[None]),
                              cpu.state, torch.tensor([len(prompt)]),
                              torch.tensor([len(seq)]))[0, -1].numpy()
    top = np.sort(y)[-2:]
    return float((top[1] - top[0]) / abs(top[1]))


def check_equal_streams(cpu, mix, ours, theirs, tag, what,
                        phase="generate-spec") -> int:
    """Each stream of ``ours`` equals ``theirs`` or parts from it only at
    a near-tie of the CPU plain path (top-2 gap below
    ``profile_generate.TIE_TOL``); returns the number of near-tie
    partings and raises on any other."""
    from deeplearning4j_tpu_torch.tools import profile_generate as pg
    ties = 0
    for i, (a, b) in enumerate(zip(ours, theirs)):
        gap = split_gap(cpu, mix[i], a, b)
        if gap is None:
            continue
        if not gap < pg.TIE_TOL:
            raise AssertionError(f"{tag}: stream {i} parts from {what} at a "
                                 f"top-2 gap of {gap:.3g}")
        ties += 1
    if len(ours) != len(theirs):
        raise AssertionError(f"{tag}: {len(ours)} streams vs {len(theirs)}")
    log(f"[{phase}] {tag}: {len(ours)} streams equal {what}"
        + (f" but for {ties} parting at a near-tie" if ties else ""))
    return ties


def log_spec_row(tag, row) -> None:
    sp = row.get("speculative") or {}
    pool = row.get("page_pool") or {}
    log(f"[{tag}] {row['requests']} requests x {row['slots']} slots, prompts"
        f" {row['prompt_tokens'][0]}-{row['prompt_tokens'][1]} tokens, "
        f"{row['new_tokens']} new tokens: wall {row['wall_ms_median']:.3f} "
        f"ms (median of {len(row['walls_ms'])}), {row['tokens_per_s']:.1f} "
        f"tokens/s, TTFT p50/p99 {row['ttft_ms_p50']:.3f}/"
        f"{row['ttft_ms_p99']:.3f} ms, TPOT p50/p99 {row['tpot_ms_p50']:.3f}"
        f"/{row['tpot_ms_p99']:.3f} ms; per run {row['prefills_per_run']:.1f}"
        f" prefills, {row['decode_steps_per_run']:.1f} decode steps, "
        f"{row['verify_steps_per_run']:.1f} verify steps, "
        f"{row['draft_steps_per_run']:.1f} draft steps; accept rate "
        f"{sp.get('accept_rate')} ({sp.get('accepted')} of "
        f"{sp.get('proposed')}); pool hits/misses/forks/peak "
        f"{pool.get('prefix_hits')}/{pool.get('prefix_misses')}/"
        f"{pool.get('forks')}/{pool.get('pages_peak')} of "
        f"{pool.get('pages_total')}; device {row['device_ms']} ms (busy "
        f"share {row['device_busy_share']}), K9 {row['k9_device_ms']} ms, "
        f"K10 {row['k10_device_ms']} ms, K3 {row['k3_device_ms']} ms")
    log(f"[{tag}] top kernels (ms per run): " + "; ".join(
        f"{k[:50]} {t:.3f} x{c}" for k, t, c in row["top_kernels_ms"][:6]))


def phase_generate_paged(counters, gen) -> dict:
    """The bench's paged prefix mix, 3 runs: the streams against the
    contiguous batcher's on the card and the CPU plain path's
    teacher-forced argmax; prefix hits, misses, forks and the peak."""
    from deeplearning4j_tpu_torch.serving.batcher import ContinuousBatcher
    from deeplearning4j_tpu_torch.tools import profile_generate as pg
    net, cpu = gen["net"], gen["cpu"]
    mix = pg.system_prompt_mix()
    contiguous = ContinuousBatcher(net, **dict(pg.BENCH, max_new_tokens=16))
    try:
        want = pg.serve(contiguous, mix)[0]
    finally:
        contiguous.shutdown()
    t0 = time.perf_counter()
    cb = ContinuousBatcher(net, **pg.PAGED)
    log(f"[generate-paged] ContinuousBatcher({pg.PAGED}) built and warmed in "
        f"{time.perf_counter() - t0:.1f} s: {cb.engine.pages} pages of "
        f"{cb.engine.page_size} rows, {cb.engine.pool_bytes()} pool bytes")
    try:
        row = spec_path(cb, mix, 3, counters)
    finally:
        cb.shutdown()
    log_spec_row("generate-paged", row)
    pool = row["page_pool"]  # read after the 3 timed runs
    # every admission but the first hits the registered prompt: one miss,
    # one prefill, and a fork of the partial last page per stream
    if pool["prefix_misses"] != 1 or row["prefills"] != 1 \
            or pool["prefix_hits"] != 3 * len(mix) - 1 \
            or pool["forks"] != 3 * len(mix) or row["verify_steps"]:
        raise AssertionError(f"paged mix: pool {pool}, {row['prefills']} "
                             f"prefills")
    if row["streams"] != want:
        raise AssertionError("paged mix: the streams differ from the "
                             "contiguous batcher's on the card")
    log(f"[generate-paged] the {len(mix)} streams equal the contiguous "
        f"batcher's on the card; {row['prefills']} prefill for "
        f"{pool['prefix_hits'] + pool['prefix_misses']} admissions")
    row["check"] = check_streams(cpu, mix, row, len(mix), "paged")
    streams = row.pop("streams")
    del row["last_logits"]
    return {"row": row, "streams": streams, "mix": mix}


def phase_generate_spec(counters, gen, paged) -> dict:
    """The speculative mix and the speculative growth mix with the target
    as its own draft, then the speculative mix with an other-seed draft:
    3 K10 launches per verify step, 3 K9 per draft step, every stream the
    plain greedy stream of the same mix under the tie rule."""
    from deeplearning4j_tpu_torch.serving.batcher import ContinuousBatcher
    from deeplearning4j_tpu_torch.tools import profile_generate as pg
    net, cpu = gen["net"], gen["cpu"]
    other = pg.build(seed=1, device="cuda")
    grow_mix = pg.prompts(*pg.GROW_PROMPTS)
    spec = dict(speculate_k=pg.SPECULATE_K)
    rows = {}
    for tag, kw, mix, runs, greedy, checked in (
            ("spec", dict(pg.PAGED, draft_model=net, **spec),
             paged["mix"], 3, paged["streams"], len(paged["mix"])),
            ("spec_grow", dict(pg.GROW_PAGED, draft_model=net, **spec),
             grow_mix, 2, gen["streams"]["grow"], GROW_CHECKED),
            ("spec_other_draft", dict(pg.PAGED, draft_model=other, **spec),
             paged["mix"], 1, paged["streams"], len(paged["mix"]))):
        t0 = time.perf_counter()
        cb = ContinuousBatcher(net, **kw)
        log(f"[generate-spec] {tag}: built and warmed in "
            f"{time.perf_counter() - t0:.1f} s")
        try:
            row = spec_path(cb, mix, runs, counters)
        finally:
            cb.shutdown()
        log_spec_row(f"generate-spec] [{tag}", row)
        row["ties_vs_greedy"] = check_equal_streams(
            cpu, mix, row["streams"], greedy, tag, "the plain greedy streams")
        row["check"] = check_streams(cpu, mix, row, checked, tag)
        rate = row["speculative"]["accept_rate"]
        if tag == "spec_other_draft":
            if not rate < 1.0:
                raise AssertionError(f"{tag}: accept rate {rate}")
        elif rate != 1.0 and not (row["check"]["near_ties"]
                                  or row["ties_vs_greedy"]):
            raise AssertionError(f"{tag}: the target as its own draft "
                                 f"accepts {rate} with no near-tie")
        log(f"[generate-spec] {tag}: accept rate {rate}"
            + ("" if rate in (None, 1.0) or tag == "spec_other_draft" else
               f" (near-ties in the streams: {row['check']['near_ties']})"))
        del row["streams"], row["last_logits"]
        rows[tag] = row
    return {"rows": rows}


def phase_generate_spec_server(counters, server_mod, net) -> dict:
    """One POST /generate through a paged, speculative
    ``JsonModelServer``: its NDJSON tokens equal ``batcher.generate``."""
    from deeplearning4j_tpu_torch.tools import profile_generate as pg
    k1, k3, k8, k9, k10, fa, pk = counters
    srv = server_mod.JsonModelServer(net, generate=dict(
        pg.PAGED, draft_model=net, speculate_k=pg.SPECULATE_K,
        max_new_tokens=SERVER_NEW))
    port = srv.start()
    cb = srv.generator
    k3.launches = k9.launches = k10.launches = 0
    fa.reset_counters()
    before = (cb.engine.verify_steps, cb.draft.decode_steps)
    try:
        tokens = [int(t) for t in pg.system_prompt_mix()[0].argmax(-1)]
        body = json.dumps({"tokens": tokens, "stream": True}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/generate", data=body),
                timeout=120) as r:
            lines = [json.loads(x) for x in r.read().decode().splitlines()
                     if x]
        want = cb.generate(tokens=tokens)["tokens"]
        streamed = [x.get("token") for x in lines[:-1]]
        if not lines[-1].get("done") or streamed != want \
                or lines[-1]["tokens"] != want or len(want) != SERVER_NEW:
            raise AssertionError(f"paged speculative POST /generate: "
                                 f"{lines[-1]} vs {want}")
        torch.cuda.synchronize()
        st = cb.stats()
    finally:
        srv.stop()
    verify = cb.engine.verify_steps - before[0]
    dsteps = cb.draft.decode_steps - before[1]
    if k10.launches != GEN_LAYERS * verify or verify == 0 \
            or k9.launches != GEN_LAYERS * dsteps \
            or fa.decode_counters()["decode_multiquery"] != k10.launches \
            or fa.decode_counters()["decode_multiquery_fallback"]:
        raise AssertionError(f"paged speculative server: {k10.launches} K10 "
                             f"/ {k9.launches} K9 launches for {verify} "
                             f"verify / {dsteps} draft steps, decisions "
                             f"{fa.decode_counters()}")
    log(f"[generate-server] POST /generate through JsonModelServer(generate="
        f"dict(paged=True, page_size=16, draft_model=net, speculate_k="
        f"{pg.SPECULATE_K})): the NDJSON stream ({SERVER_NEW} tokens) "
        f"equals batcher.generate; {k10.launches} K10 launches for {verify} "
        f"verify steps, {k9.launches} K9 for {dsteps} draft steps; accept "
        f"rate {st['speculative']['accept_rate']}, pool hits "
        f"{st['page_pool']['prefix_hits']}")
    return {"launches": {"k3": k3.launches, "k9": k9.launches,
                         "k10": k10.launches}}


def settle(cb, timeout: float = 10.0) -> None:
    """Wait until ``cb``'s worker holds no slot and no horizon, so that
    counts zeroed next see only the next window's launches."""
    t_end = time.perf_counter() + timeout
    while (cb.active_slots() or cb._inflight is not None
           or cb._q.qsize()) and time.perf_counter() < t_end:
        time.sleep(0.002)
    torch.cuda.synchronize()


def ship_over_socket(ship):
    """``ship`` through a ``socket.socketpair()``: ``to_bytes`` ->
    ``write_msg`` -> ``read_msg`` -> ``from_bytes``. Raises unless the
    bytes, the payload, the logits and the handoff come back bit for bit.
    Returns ``(shipment, bytes, wire seconds)``."""
    from deeplearning4j_tpu_torch.serving import disagg
    blob = ship.to_bytes()
    a, b = socket.socketpair()
    try:
        t0 = time.perf_counter()
        writer = threading.Thread(target=disagg.write_msg, args=(a, blob))
        writer.start()
        got = disagg.read_msg(b)
        wire = time.perf_counter() - t0
        writer.join()
    finally:
        a.close()
        b.close()
    back = disagg.KVShipment.from_bytes(got)
    same = got == blob and back.pages == ship.pages \
        and back.plen == ship.plen and back.prefix_key == ship.prefix_key \
        and np.array_equal(back.logits, ship.logits) \
        and set(back.payload) == set(ship.payload) and all(
            set(back.payload[l]) == set(lv) and all(
                torch.equal(back.payload[l][n], t) for n, t in lv.items())
            for l, lv in ship.payload.items())
    if not same:
        raise AssertionError("a shipment did not come back bit for bit "
                             "through the socket")
    return back, len(blob), wire


def drive_window(submit_short, submit_long, shorts, longs) -> dict:
    """One window of the mixed load: the interactive and the long
    requests submitted from threads, arrivals interleaved as the bench
    interleaves them; the TTFT of each taken by its submitting thread
    (submit -> first streamed token). Returns ``{"short"/"long": [(ttft
    s, tokens, last logits)]}`` in prompt order and the window's wall
    seconds."""
    out = {"short": [None] * len(shorts), "long": [None] * len(longs)}
    errors = []

    def one(submit, kind, i, prompt):
        try:
            t0 = time.perf_counter()
            h = submit(prompt)
            next(h.tokens(timeout=300))
            ttft = time.perf_counter() - t0
            r = h.result(timeout=300)
            out[kind][i] = (ttft, r["tokens"], r["logits"])
        except BaseException as e:  # raised in the driving thread below
            errors.append(e)

    threads = []
    for i in range(max(len(shorts), len(longs))):
        if i < len(longs):
            threads.append(threading.Thread(
                target=one, args=(submit_long, "long", i, longs[i])))
        if i < len(shorts):
            threads.append(threading.Thread(
                target=one, args=(submit_short, "short", i, shorts[i])))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    out["wall_s"] = wall
    return out


def window_launches(counters, want_k3, want_k9, tag) -> dict:
    """Raise unless the window launched ``want_k3`` K3 and ``want_k9`` K9
    and nothing else, with only ``fused`` and ``decode_fused``
    decisions."""
    k1, k3, k8, k9, k10, fa, pk = counters
    want_dec = {k: 0 for k in fa.decode_counters()}
    want_dec["decode_fused"] = k9.launches
    want_att = {k: 0 for k in fa.counters()}
    want_att["fused"] = k3.launches
    if k3.launches != want_k3 or k9.launches != want_k9 or want_k9 == 0 \
            or k10.launches or k1.launches or k1.bwd_launches \
            or k8.launches or fa.decode_counters() != want_dec \
            or fa.counters() != want_att:
        raise AssertionError(
            f"{tag}: {k3.launches} K3 (want {want_k3}), {k9.launches} K9 "
            f"(want {want_k9}), {k10.launches} K10, K1/K2/K8 {k1.launches}/"
            f"{k1.bwd_launches}/{k8.launches}, decisions {fa.counters()} "
            f"{fa.decode_counters()}")
    return {"k3": k3.launches, "k9": k9.launches, "k10": 0}


def zero_counts(counters) -> None:
    k1, k3, k8, k9, k10, fa, pk = counters
    k1.launches = k1.bwd_launches = k3.launches = k8.launches = 0
    k9.launches = k10.launches = 0
    fa.reset_counters()
    pk.reset_counters()


def ms_pct(values, q):
    return float(np.percentile(np.asarray(values), q) * 1e3)


def phase_disagg(counters, gen) -> dict:
    """Disaggregated serving on the bench's generative model: the mixed
    load colocated and split in interleaved rounds, every long prompt's
    shipment through a socketpair; then the router over two decode
    replicas on the growth mix, twice."""
    from deeplearning4j_tpu_torch.serving import PrefillReplica
    from deeplearning4j_tpu_torch.serving.batcher import ContinuousBatcher
    net = gen["net"]
    P = DISAGG_PAGE
    n_slots = DISAGG_SHORT + DISAGG_LONG
    t0 = time.perf_counter()
    colo = ContinuousBatcher(net, slots=n_slots, max_cache_len=DISAGG_CACHE,
                             paged=True, page_size=P,
                             max_new_tokens=DISAGG_NEW_SHORT,
                             pool_label="colocated")
    pre = PrefillReplica(net, pages=257, page_size=P,
                         max_cache_len=DISAGG_CACHE,
                         prompt_buckets=[16, DISAGG_CACHE])
    dec = ContinuousBatcher(net, slots=n_slots, max_cache_len=DISAGG_CACHE,
                            paged=True, page_size=P,
                            max_new_tokens=DISAGG_NEW_SHORT,
                            pool_label="decode",
                            migrate_buckets=[-(-DISAGG_PLEN_LONG // P)])
    log(f"[disagg] colocated ContinuousBatcher, PrefillReplica and decode "
        f"ContinuousBatcher (slots {n_slots}, cache {DISAGG_CACHE}, pages of "
        f"{P} rows, migrate_buckets [{-(-DISAGG_PLEN_LONG // P)}]) built and "
        f"warmed in {time.perf_counter() - t0:.1f} s")
    try:
        row = mixed_load(counters, gen, colo, pre, dec)
    finally:
        colo.shutdown()
        dec.shutdown()
    row["router"] = router_round(counters, gen)
    return row


def mixed_load(counters, gen, colo, pre, dec) -> dict:
    """[disagg]'s mixed load over the colocated front ``colo`` and the
    split pair ``pre`` + ``dec`` (see ``phase_disagg``)."""
    from deeplearning4j_tpu_torch.tools import profile_generate as pg
    cpu = gen["cpu"]
    eye = np.eye(pg.VOCAB, dtype=np.float32)
    P = DISAGG_PAGE
    ships = []   # (bytes, wire s, pages)

    def split_long(prompt):
        ship = pre.prefill(prompt)
        back, nbytes, wire = ship_over_socket(ship)
        ships.append((nbytes, wire, len(ship.pages)))
        return dec.submit_prefilled(back, max_new_tokens=DISAGG_NEW_LONG)

    def colo_long(prompt):
        return colo.submit(prompt=prompt, max_new_tokens=DISAGG_NEW_LONG)

    sides = {"colocated": (colo, lambda p: colo.submit(prompt=p), colo_long),
             "split": (dec, lambda p: dec.submit(prompt=p), split_long)}
    ttft = {s: [] for s in sides}
    tpot = {s: [] for s in sides}
    ratios, launches = [], {s: {"k3": 0, "k9": 0, "k10": 0} for s in sides}
    ties, checked = 0, 0
    worst = {"violations": 0, "near_ties": 0, "last_rel_err": 0.0}

    def window(side, shorts, longs):
        cb, sub_short, sub_long = sides[side]
        settle(colo)
        settle(dec)
        zero_counts(counters)
        eng = cb.engine
        before = (eng.prefill_runs, eng.decode_steps,
                  pre.engine.prefill_runs, eng.pool.stats()["adoptions"],
                  len(cb._tpot))
        res = drive_window(sub_short, sub_long, shorts, longs)
        settle(cb)
        prefills = eng.prefill_runs - before[0]
        steps = eng.decode_steps - before[1]
        pre_prefills = pre.engine.prefill_runs - before[2]
        adopt = eng.pool.stats()["adoptions"] - before[3]
        n_pages = sum(-(-len(p) // P) for p in longs)
        if side == "colocated":
            want = len(shorts) + len(longs)
            if prefills != want or pre_prefills:
                raise AssertionError(f"[disagg] colocated: {prefills} "
                                     f"prefills for {want} fresh prompts")
        elif prefills != len(shorts) or pre_prefills != len(longs) \
                or adopt != n_pages:
            raise AssertionError(
                f"[disagg] split: {prefills} decode-side prefills (want "
                f"{len(shorts)}: none for a migrated request), "
                f"{pre_prefills} replica prefills (want {len(longs)}), "
                f"{adopt} pages adopted (want {n_pages})")
        got = window_launches(counters, GEN_LAYERS * (prefills + pre_prefills),
                              GEN_LAYERS * steps, f"[disagg] {side}")
        for k in got:
            launches[side][k] += got[k]
        return res, steps, list(cb._tpot)[before[4]:]

    rng = np.random.default_rng(DISAGG_SEED)
    for r in range(DISAGG_ROUNDS):
        shorts = [eye[rng.integers(0, pg.VOCAB, DISAGG_PLEN_SHORT)]
                  for _ in range(DISAGG_SHORT)]
        longs = [eye[rng.integers(0, pg.VOCAB, DISAGG_PLEN_LONG)]
                 for _ in range(DISAGG_LONG)]
        out = {}
        for side in sides:
            out[side], _, tp = window(side, shorts, longs)
            ttft[side] += [t for t, _, _ in out[side]["short"]]
            tpot[side] += tp
        ratios.append(np.percentile([t for t, _, _ in out["colocated"][
            "short"]], 99) / np.percentile([t for t, _, _ in out["split"][
                "short"]], 99))
        prompts = shorts + longs
        ours = [x[1] for x in out["split"]["short"] + out["split"]["long"]]
        theirs = [x[1] for x in out["colocated"]["short"]
                  + out["colocated"]["long"]]
        ties += check_equal_streams(cpu, prompts, ours, theirs,
                                    f"round {r}",
                                    "the colocated paged batcher's",
                                    phase="disagg")
        for p, x in zip(prompts, out["split"]["short"]
                        + out["split"]["long"]):
            tf = pg.teacher_forced(cpu, p, x[1], x[2])
            worst["violations"] += tf["violations"]
            worst["near_ties"] += tf["near_ties"]
            worst["last_rel_err"] = max(worst["last_rel_err"],
                                        tf["last_rel_err"])
            checked += 1
    if worst["violations"] or not worst["last_rel_err"] <= GEN_REL_TOL:
        raise AssertionError(f"[disagg] the split streams disagree with the "
                             f"CPU plain path: {worst}")
    # one profiled window a side (fresh prompts, outside the TTFT rows)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    shorts = [eye[rng.integers(0, pg.VOCAB, DISAGG_PLEN_SHORT)]
              for _ in range(DISAGG_SHORT)]
    longs = [eye[rng.integers(0, pg.VOCAB, DISAGG_PLEN_LONG)]
             for _ in range(DISAGG_LONG)]
    prof_rows = {}
    for side in sides:
        with torch.profiler.profile(activities=acts) as prof:
            res, steps, _ = window(side, shorts, longs)
        dev, k9ms, _, k3ms, _ = pg._kernel_split(prof)
        prof_rows[side] = {"wall_ms": res["wall_s"] * 1e3, "device_ms": dev,
                           "busy_share": dev / (res["wall_s"] * 1e3),
                           "k9_ms": k9ms, "k3_ms": k3ms,
                           "decode_steps": steps}
    # the host seconds of each shipment's export (replica) and import
    # (decode pool), as the engines time them
    exports = list(pre.engine.migrate_s["export"])[-len(ships):]
    imports = list(dec.engine.migrate_s["import"])[-len(ships):]
    row = {
        "ttft_ms_p50": {s: ms_pct(v, 50) for s, v in ttft.items()},
        "ttft_ms_p99": {s: ms_pct(v, 99) for s, v in ttft.items()},
        "ttft_p99_ratio_colocated_over_split": float(np.median(ratios)),
        "ttft_p99_ratios": [float(x) for x in ratios],
        "tpot_ms_p50": {s: ms_pct(v, 50) if v else None
                        for s, v in tpot.items()},
        "shipments": len(ships),
        "bytes_per_shipment": float(np.mean([s[0] for s in ships])),
        "pages_per_shipment": float(np.mean([s[2] for s in ships])),
        "wire_mb_per_s": sum(s[0] for s in ships) / sum(s[1] for s in ships)
        / 1e6,
        "export_ms_p50": ms_pct(exports, 50),
        "import_ms_p50": ms_pct(imports, 50),
        "profiled": prof_rows, "launches": launches,
        "streams_checked": checked, "near_tie_partings": ties,
        "cpu_check": worst,
    }
    log(f"[disagg] mixed load, {DISAGG_ROUNDS} interleaved rounds of "
        f"{DISAGG_SHORT} interactive ({DISAGG_PLEN_SHORT} tokens x "
        f"{DISAGG_NEW_SHORT} new) and {DISAGG_LONG} long ({DISAGG_PLEN_LONG} "
        f"x {DISAGG_NEW_LONG}) requests: interactive TTFT p50/p99 colocated "
        f"{row['ttft_ms_p50']['colocated']:.3f}/"
        f"{row['ttft_ms_p99']['colocated']:.3f} ms, split "
        f"{row['ttft_ms_p50']['split']:.3f}/{row['ttft_ms_p99']['split']:.3f}"
        f" ms, p99 ratio colocated/split "
        f"{row['ttft_p99_ratio_colocated_over_split']:.3f} (rounds "
        f"{', '.join(f'{x:.3f}' for x in ratios)}); TPOT p50 colocated "
        f"{row['tpot_ms_p50']['colocated']} ms, split "
        f"{row['tpot_ms_p50']['split']} ms")
    log(f"[disagg] {len(ships)} shipments through a socketpair, bit for bit: "
        f"{row['bytes_per_shipment']:.0f} bytes "
        f"({row['pages_per_shipment']:.0f} pages) each, wire "
        f"{row['wire_mb_per_s']:.1f} MB/s, export p50 "
        f"{row['export_ms_p50']:.3f} ms, import p50 "
        f"{row['import_ms_p50']:.3f} ms (host); {checked} split streams "
        f"equal the colocated paged batcher's"
        + (f" but for {ties} parting at a near-tie" if ties else "")
        + f" and pass the CPU teacher-forced check (last-step "
        f"{worst['last_rel_err']:.3g}); K3 3 a prefill, K9 3 a decode step, "
        f"0 decode-side prefills for migrated requests")
    for side, pr in prof_rows.items():
        log(f"[disagg] profiled {side} window: wall {pr['wall_ms']:.3f} ms, "
            f"device {pr['device_ms']:.3f} ms (busy share "
            f"{pr['busy_share']:.3f}), K9 {pr['k9_ms']:.3f} ms, K3 "
            f"{pr['k3_ms']:.3f} ms, {pr['decode_steps']} decode steps")
    return row


def router_round(counters, gen) -> dict:
    """``DisaggRouter([pre], [d0, d1])`` on the growth mix's 32 prompts x
    ``ROUTER_NEW`` new tokens, twice: the first pass prefills each prompt
    once and migrates it, the second routes each to its resident decode
    replica."""
    from deeplearning4j_tpu_torch.serving import DisaggRouter, PrefillReplica
    from deeplearning4j_tpu_torch.serving.batcher import ContinuousBatcher
    from deeplearning4j_tpu_torch.tools import profile_generate as pg
    net, cpu = gen["net"], gen["cpu"]
    P = DISAGG_PAGE
    cache = pg.GROW["max_cache_len"]
    mix = pg.prompts(*pg.GROW_PROMPTS)
    t0 = time.perf_counter()
    pre = PrefillReplica(net, pages=1 + len(mix) * (cache // P),
                         page_size=P, max_cache_len=cache,
                         prompt_buckets=[256, 512])
    decs = [ContinuousBatcher(net, slots=ROUTER_SLOTS, max_cache_len=cache,
                              min_cache_len=pg.GROW["min_cache_len"],
                              paged=True, page_size=P, pages=ROUTER_PAGES,
                              max_new_tokens=ROUTER_NEW,
                              migrate_buckets=[256 // P, 512 // P],
                              pool_label="decode") for _ in range(2)]
    log(f"[disagg] router: PrefillReplica ({pre.engine.pages} pages) and 2 "
        f"decode ContinuousBatchers ({ROUTER_SLOTS} slots, {ROUTER_PAGES} "
        f"pages, cache {cache}) built and warmed in "
        f"{time.perf_counter() - t0:.1f} s")
    shipped = sum(-(-len(p) // P) for p in mix)
    colo = ContinuousBatcher(net, **dict(pg.GROW_PAGED,
                                         max_new_tokens=ROUTER_NEW))
    try:
        colo_streams = pg.serve(colo, mix)[0]
    finally:
        colo.shutdown()
    passes, launches = [], {"k3": 0, "k9": 0, "k10": 0}
    try:
        with DisaggRouter([pre], decs, max_new_tokens=ROUTER_NEW) as router:
            for n in range(2):
                for cb in decs:
                    settle(cb)
                zero_counts(counters)
                before = [(cb.engine.prefill_runs, cb.engine.decode_steps,
                           cb.engine.pool.stats()["adoptions"],
                           cb.stats()["requests"]) for cb in decs]
                p0 = pre.engine.prefill_runs
                t1 = time.perf_counter()
                res = [h.result(timeout=600) for h in
                       [router.submit(prompt=p) for p in mix]]
                wall = time.perf_counter() - t1
                for cb in decs:
                    settle(cb)
                st = router.stats()
                dec_prefills = sum(cb.engine.prefill_runs - b[0]
                                   for cb, b in zip(decs, before))
                steps = sum(cb.engine.decode_steps - b[1]
                            for cb, b in zip(decs, before))
                adopt = sum(cb.engine.pool.stats()["adoptions"] - b[2]
                            for cb, b in zip(decs, before))
                pre_prefills = pre.engine.prefill_runs - p0
                want = (len(mix), len(mix), 0) if n == 0 else \
                    (len(mix), len(mix), len(mix))
                if (st["migrations"], st["routed_prefill"],
                        st["routed_prefix_hit"]) != want or dec_prefills \
                        or adopt != (shipped if n == 0 else 0) \
                        or pre_prefills != (len(mix) if n == 0 else 0):
                    raise AssertionError(
                        f"[disagg] router pass {n}: migrations/prefill/hits "
                        f"{st['migrations']}/{st['routed_prefill']}/"
                        f"{st['routed_prefix_hit']} (want {want}), "
                        f"{dec_prefills} decode-side prefills, {adopt} pages "
                        f"adopted (want {shipped if n == 0 else 0}), "
                        f"{pre_prefills} replica prefills")
                got = window_launches(counters, GEN_LAYERS * pre_prefills,
                                      GEN_LAYERS * steps,
                                      f"[disagg] router pass {n}")
                for k in got:
                    launches[k] += got[k]
                stats = [cb.stats() for cb in decs]
                passes.append({
                    "wall_ms": wall * 1e3, "decode_steps": steps,
                    "tokens_per_s": sum(len(r["tokens"]) for r in res)
                    / wall,
                    "requests_by_replica": [s["requests"] - b[3] for s, b
                                            in zip(stats, before)],
                    "streams": [r["tokens"] for r in res],
                    "logits": [r["logits"] for r in res]})
            health = router.health()
    finally:
        for cb in decs:
            cb.shutdown()
    if any(v != "HEALTHY" for v in health.values()):
        raise AssertionError(f"[disagg] router health {health}")
    first, second = passes
    ties = check_equal_streams(cpu, mix, second["streams"], first["streams"],
                               "router pass 2", "the first pass's",
                               phase="disagg")
    ties += check_equal_streams(cpu, mix, first["streams"], colo_streams,
                                "router pass 1",
                                "a colocated paged batcher's",
                                phase="disagg")
    worst = check_streams(cpu, mix, {"streams": first["streams"],
                                     "last_logits": first["logits"]},
                          len(mix), "router pass 1", phase="disagg")
    for p in passes:
        del p["streams"], p["logits"]
    log(f"[disagg] router over 2 decode replicas, the growth mix's "
        f"{len(mix)} prompts x {ROUTER_NEW} new tokens: pass 1 "
        f"{first['wall_ms']:.1f} ms ({first['tokens_per_s']:.1f} tokens/s; "
        f"32 prefills, 32 migrations of {shipped} pages in all, requests by "
        f"replica {first['requests_by_replica']}), pass 2 "
        f"{second['wall_ms']:.1f} ms ({second['tokens_per_s']:.1f} tokens/s;"
        f" 32 resident-prefix hits, no prefill, no migration); health "
        f"{health}")
    return {"passes": passes, "pages_shipped": shipped,
            "launches": launches, "near_tie_partings": ties,
            "cpu_check": worst}


def expect_launches(counters, want, total, tag) -> None:
    """Raise unless the launches since the last ``zero_counts`` are
    ``want`` (K3, K9, K10) with matching ``fused``, ``decode_fused`` and
    ``decode_multiquery`` decisions and nothing else; add them to
    ``total``."""
    k1, k3, k8, k9, k10, fa, pk = counters
    torch.cuda.synchronize()
    got = (k3.launches, k9.launches, k10.launches)
    dec = fa.decode_counters()
    if got != tuple(want) or fa.counters()["fused"] != k3.launches \
            or sum(fa.counters().values()) != k3.launches \
            or dec["decode_fused"] != k9.launches \
            or dec["decode_multiquery"] != k10.launches \
            or sum(dec.values()) != k9.launches + k10.launches \
            or k1.launches or k8.launches:
        raise AssertionError(f"{tag}: {got} K3, K9, K10 launches (want "
                             f"{tuple(want)}), decisions {fa.counters()} "
                             f"{dec}")
    for k, n in zip(("k3", "k9", "k10"), got):
        total[k] += n


def sd_decode_graph(sd_cls, rng_weights, device):
    """``tests/test_generative_decode.py::_mini_sd_transformer`` stacked
    ``SDD_BLOCKS`` times on ``[B, H, T, d]`` hidden states, its weights
    the given ``[d, d]`` arrays."""
    sd = sd_cls(device=device)
    x = sd.placeholder("x")
    mask = sd.placeholder("mask")
    dk = sd.constant("dk", np.float32(np.sqrt(SDD_D)))
    for i in range(SDD_BLOCKS):
        wq, wk, wv, wo = (sd.var(f"{n}{i}", rng_weights[f"{n}{i}"])
                          for n in ("Wq", "Wk", "Wv", "Wo"))
        q = sd.call("linalg.mmul", x, wq, name=f"q{i}")
        k = sd.call("linalg.mmul", x, wk, name=f"k{i}")
        v = sd.call("linalg.mmul", x, wv, name=f"v{i}")
        scores = sd.call("linalg.mmul", q, k, name=f"scores{i}",
                         attrs={"transpose_b": True})
        scaled = sd.call("math.div", scores, dk, name=f"scaled{i}")
        masked = sd.call("math.add", scaled, mask, name=f"masked{i}")
        probs = sd.call("act.softmax", masked, name=f"probs{i}")
        ctx = sd.call("linalg.mmul", probs, v, name=f"ctx{i}")
        x = sd.call("linalg.mmul", ctx, wo,
                    name="out" if i == SDD_BLOCKS - 1 else f"h{i}")
    return sd


def prefix_lm_bias(plens, lengths, t):
    """The full-prefix recompute's mask: each prompt bidirectional over
    itself, generated rows causal, rows past a stream's length masked."""
    ii, jj = np.arange(t)[:, None], np.arange(t)[None, :]
    allowed = ((jj < plens[:, None, None]) | (jj <= ii)) \
        & (jj < lengths[:, None, None])
    return np.where(allowed[:, None], 0.0, np.finfo(np.float32).min).astype(
        np.float32)


def phase_sd_decode(counters, env) -> dict:
    """SameDiff decode graphs at BERT-base's attention shape: 12 fused
    sites rewritten contiguous and paged; a ragged prefill, 32 decode
    steps and (paged) a window of 4 rows, each against the base graph
    recomputed over the full prefix on the card and the CPU plain path;
    12 K3 a prefill, 12 K9 a step, 12 K10 a window."""
    from deeplearning4j_tpu_torch.autodiff.decode import rewrite_for_decode
    from deeplearning4j_tpu_torch.autodiff.fusion import fuse_attention
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    env.Environment.instance().f32_matmul_precision = "highest"
    rng = np.random.default_rng(SDD_SEED)
    w = {f"{n}{i}": (rng.standard_normal((SDD_D, SDD_D))
                     / np.sqrt(SDD_D)).astype(np.float32)
         for i in range(SDD_BLOCKS) for n in ("Wq", "Wk", "Wv", "Wo")}
    B, H, d, C = SDD_B, SDD_H, SDD_D, SDD_CACHE
    t0 = time.perf_counter()
    graphs = {}
    for where in ("cuda", "cpu"):
        for paged in (False, True):
            sd = sd_decode_graph(SameDiff, w, where)
            rep = fuse_attention(sd)
            if rep.matched != SDD_BLOCKS or rep.unmatched:
                raise AssertionError(f"[sd-decode] fuse_attention matched "
                                     f"{rep.matched}, {rep.unmatched} "
                                     f"unmatched")
            graphs[where, paged] = rewrite_for_decode(
                sd, output="out", paged=paged, page_size=SDD_PAGE)
    plens = rng.integers(SDD_PLEN[0], SDD_PLEN[1], B)
    tp = int(plens.max())
    xp = (rng.standard_normal((B, H, tp, d)) * 0.5).astype(np.float32)
    kb = np.where(np.arange(tp)[None, None, None, :]
                  < plens[:, None, None, None], 0.0,
                  np.finfo(np.float32).min).astype(np.float32)
    steps = [(rng.standard_normal((B, H, 1, d)) * 0.5).astype(np.float32)
             for _ in range(SDD_STEPS)]
    window = (rng.standard_normal((B, H, SDD_WINDOW, d)) * 0.5).astype(
        np.float32)
    m1 = np.zeros((B, 1, 1, 1), np.float32)
    seq = np.zeros((B, H, C, d), np.float32)
    seq[:, :, :tp] = xp
    outs = {}
    worst = {"full_prefix": 0.0, "cpu": 0.0, "paged_vs_cached": 0.0,
             "window": 0.0}
    launches = {"k3": 0, "k9": 0, "k10": 0}
    for key, dg in graphs.items():
        card = key[0] == "cuda"
        if card:
            zero_counts(counters)
        y, caches = dg.prefill({"x": xp, "mask": kb}, plens, C)
        if card:
            expect_launches(counters, (SDD_BLOCKS, 0, 0), launches,
                            "[sd-decode] prefill")
        lengths = plens.copy()
        ys = []
        for x_t in steps:
            if card:
                zero_counts(counters)
            y, caches = dg.decode_step({"x": x_t, "mask": m1}, caches,
                                       lengths)
            if card:
                expect_launches(counters, (0, SDD_BLOCKS, 0), launches,
                                "[sd-decode] decode step")
            ys.append(y[:, :, 0])
            lengths = lengths + 1
        outs[key] = ys
        if key[1]:   # the paged replay: then a window of 4 rows
            if card:
                zero_counts(counters)
            yw, _ = dg.decode_step({"x": window, "mask": m1}, caches,
                                   lengths)
            if card:
                expect_launches(counters, (0, 0, SDD_BLOCKS), launches,
                                "[sd-decode] window")
            outs[key + ("window",)] = yw
    # the base graph over the full prefix, on the card
    base = graphs["cuda", False].base
    lengths = plens.copy()
    for i, x_t in enumerate(steps):
        for b in range(B):
            seq[b, :, lengths[b]] = x_t[b, :, 0]
        lengths = lengths + 1
        t = int(lengths.max())
        ref = base.output({"x": seq[:, :, :t],
                           "mask": prefix_lm_bias(plens, lengths, t)},
                          ["out"])["out"][np.arange(B), :, lengths - 1]
        scale = np.abs(ref).max()
        worst["full_prefix"] = max(worst["full_prefix"], float(
            np.abs(outs["cuda", False][i] - ref).max() / scale))
        worst["cpu"] = max(worst["cpu"], float(
            np.abs(outs["cuda", False][i] - outs["cpu", False][i]).max()
            / scale), float(np.abs(outs["cuda", True][i]
                                   - outs["cpu", True][i]).max() / scale))
        worst["paged_vs_cached"] = max(worst["paged_vs_cached"], float(
            np.abs(outs["cuda", True][i] - outs["cuda", False][i]).max()
            / scale))
    for j in range(SDD_WINDOW):
        for b in range(B):
            seq[b, :, lengths[b] + j] = window[b, :, j]
    t = int(lengths.max()) + SDD_WINDOW
    full = lengths + SDD_WINDOW
    ref = base.output({"x": seq[:, :, :t],
                       "mask": prefix_lm_bias(plens, full, t)}, ["out"])["out"]
    refw = np.stack([ref[b, :, lengths[b]:lengths[b] + SDD_WINDOW]
                     for b in range(B)])
    for key in (("cuda", True, "window"), ("cpu", True, "window")):
        worst["window"] = max(worst["window"], float(
            np.abs(outs[key] - refw).max() / np.abs(refw).max()))
    if not max(worst.values()) <= SDD_REL_TOL:
        raise AssertionError(f"[sd-decode] outside {SDD_REL_TOL}: {worst}")
    log(f"[sd-decode] {SDD_BLOCKS} stacked attention blocks (H {H}, d {d}), "
        f"fuse_attention {SDD_BLOCKS} matched, rewritten contiguous and "
        f"paged (page {SDD_PAGE}); B {B} prompts of {plens.min()}-"
        f"{plens.max()} tokens, cache {C}, {SDD_STEPS} decode steps, a "
        f"window of {SDD_WINDOW} rows: max|diff|/max|ref| against the full-"
        f"prefix recompute {worst['full_prefix']:.3g}, against the CPU plain "
        f"path {worst['cpu']:.3g}, paged against cached "
        f"{worst['paged_vs_cached']:.3g}, the window {worst['window']:.3g} "
        f"(tolerance {SDD_REL_TOL}); {SDD_BLOCKS} K3 a prefill, "
        f"{SDD_BLOCKS} K9 a step, {SDD_BLOCKS} K10 a window; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"rel_err": worst, "launches": launches}

def ln_violation(err, bound) -> float:
    """The largest share of its bound an error takes (NaN counts as
    infinite)."""
    share = (err / bound).nan_to_num(nan=float("inf"))
    return float(share.max()) if share.numel() else 0.0


def check_ln_case(k6, x, g, b, dy, where, err) -> tuple:
    """K6 and K7 twice each (bitwise equal) against their plain versions on
    the same inputs (K7 fed K6's own mu and rstd); folds each output's
    share of its bound into ``err`` and returns K6's ``(y, mu, rstd)``."""
    got = k6.layer_norm_act(x, g, b, LN_EPS, where[1])
    again = k6.layer_norm_act(x, g, b, LN_EPS, where[1])
    y, mu, rstd = got
    bwd = k6.layer_norm_act_bwd(x, g, b, mu, rstd, dy, where[1])
    bwd2 = k6.layer_norm_act_bwd(x, g, b, mu, rstd, dy, where[1])
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f"K6 {where} is not deterministic")
    if not all(torch.equal(a, c) for a, c in zip(bwd, bwd2)):
        raise AssertionError(f"K7 {where} is not deterministic")
    ry, rmu, rrs = k6.layer_norm_act_reference(x, g, b, LN_EPS, where[1])
    bmu, brs = k6.stats_bound(rmu, rrs)
    want = k6.layer_norm_act_bwd_reference(x, g, b, mu, rstd, dy, where[1])
    sg, sb = k6.sum_bound(x, g, b, mu, rstd, dy, where[1])
    shares = {
        "y": ln_violation((y.float() - ry.float()).abs(),
                          k6.y_bound(x, g, b, rmu, rrs, ry)),
        "mu": ln_violation((mu - rmu).abs(), bmu),
        "rstd": ln_violation((rstd - rrs).abs(), brs),
        "dx": ln_violation((bwd[0].float() - want[0].float()).abs(),
                           k6.dx_bound(x, g, b, mu, rstd, dy, want[0],
                                       where[1])),
        "dgamma": ln_violation((bwd[1] - want[1]).abs(), sg),
        "dbeta": ln_violation((bwd[2] - want[2]).abs(), sb)}
    for k, v in shares.items():
        err[k] = max(err[k], v)
    if x.dtype == torch.float32:
        err["y_abs_float32"] = max(err["y_abs_float32"],
                                   float((y - ry).abs().max()))
        err["dx_abs_float32"] = max(err["dx_abs_float32"],
                                    float((bwd[0] - want[0]).abs().max()))
        err["y_float32"] = max(err["y_float32"], shares["y"])
        err["dx_float32"] = max(err["dx_float32"], shares["dx"])
    bad = [k for k, v in shares.items() if not v <= 1.0]
    if bad:
        raise AssertionError(f"K6/K7 {where} disagree with their plain "
                             f"versions: {bad}, shares of the tolerance "
                             f"{shares}")
    return got


def phase_kernel_ln(k6) -> dict:
    """K6 and K7 against their plain versions at LN_SHAPES x 7 activations
    x 3 dtypes, twice per case for determinism; the one-pass variance
    rejected on rows far from zero; CUDA-event times at the path's shape
    beside the bounds, the plain versions and the PyTorch calls. Logs as
    [kernel-ln] and [kernel-ln-bwd]."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    err = {k: 0.0 for k in ("y", "mu", "rstd", "dx", "dgamma", "dbeta",
                            "y_abs_float32", "dx_abs_float32", "y_float32",
                            "dx_float32")}
    cases = 0
    for rows, cols in LN_SHAPES:
        g = torch.randn(cols, generator=gen, device=dev) * 0.5 + 1.0
        b = torch.randn(cols, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            x = (torch.randn(rows, cols, generator=gen, device=dev) * 2.0
                 + 0.5).to(dtype)
            dy = torch.randn(rows, cols, generator=gen, device=dev).to(dtype)
            for act in k6.ACTS:
                check_ln_case(k6, x, g, b, dy,
                              (f"{str(dtype)[6:]} ({rows}, {cols})", act),
                              err)
                cases += 1
    log(f"[kernel-ln] K6 matches its plain version and repeats bit for "
        f"bit: {cases} cases ({len(LN_SHAPES)} shapes x 7 activations x "
        f"3 dtypes); worst share of the tolerance: y {err['y']:.3g} "
        f"(float32 {err['y_float32']:.3g}), mu {err['mu']:.3g}, rstd "
        f"{err['rstd']:.3g}; max abs err y float32 "
        f"{err['y_abs_float32']:.3g}")
    log(f"[kernel-ln-bwd] K7 matches its plain version and repeats bit for "
        f"bit: the same {cases} cases; worst share of the tolerance: dx "
        f"{err['dx']:.3g} (float32 {err['dx_float32']:.3g}), dgamma "
        f"{err['dgamma']:.3g}, dbeta "
        f"{err['dbeta']:.3g}; max abs err dx float32 "
        f"{err['dx_abs_float32']:.3g}")

    # rows far from zero: the two-pass variance holds, a one-pass one fails
    rows, cols = LN_PATH_SHAPE
    g = torch.randn(cols, generator=gen, device=dev) * 0.5 + 1.0
    b = torch.randn(cols, generator=gen, device=dev)
    x = torch.randn(rows, cols, generator=gen, device=dev) + 1000.0
    dy = torch.randn(rows, cols, generator=gen, device=dev)
    offset = {}
    for act in k6.ACTS:
        check_ln_case(k6, x, g, b, dy, ("float32 offset 1000", act), err)
        ry, rmu, rrs = k6.layer_norm_act_reference(x, g, b, LN_EPS, act)
        y, _, _ = k6.layer_norm_act(x, g, b, LN_EPS, act)
        bound = k6.y_bound(x, g, b, rmu, rrs, ry)
        one = k6.one_pass_reference(x, g, b, LN_EPS, act)
        offset[act] = (ln_violation((y - ry).abs(), bound),
                       ln_violation((one - ry).abs(), bound))
        if offset[act][1] <= 1.0:
            raise AssertionError(f"the tolerance does not reject a one-pass "
                                 f"variance ({act}): {offset[act]}")
    log(f"[kernel-ln] rows of 1000 + N(0, 1) at {LN_PATH_SHAPE}: K6 within "
        f"{max(v[0] for v in offset.values()):.3g} of its tolerance; a "
        f"one-pass variance (E[x^2] - E[x]^2 in float32) at least "
        f"{min(v[1] for v in offset.values()):.3g} x the tolerance, "
        f"rejected for all 7 activations")

    # times at the path's shape: identity, the only activation on the path
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.randn(rows, cols, generator=gen, device=dev).to(dtype)
        dyt = torch.randn(rows, cols, generator=gen, device=dev).to(dtype)
        gt = g.to(dtype)
        bt = b.to(dtype)
        _, mu, rstd = k6.layer_norm_act(xt, g, b, LN_EPS, "identity")
        ms, host = time_ms(lambda: k6.layer_norm_act(xt, g, b, LN_EPS))
        plain, _ = time_ms(
            lambda: k6.layer_norm_act_reference(xt, g, b, LN_EPS))
        lib, _ = time_ms(lambda: F.layer_norm(xt, (cols,), gt, bt, LN_EPS))
        ms2, host2 = time_ms(
            lambda: k6.layer_norm_act_bwd(xt, g, b, mu, rstd, dyt))
        plain2, _ = time_ms(
            lambda: k6.layer_norm_act_bwd_reference(xt, g, b, mu, rstd, dyt))
        mu2, rs2 = mu[:, None], rstd[:, None]
        lib2, _ = time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            dyt, xt, [cols], mu2, rs2, gt, bt, [True, True, True]))
        floor2, _ = time_ms(lambda: k6.bwd_launch_floor(rows, cols, dtype))
        occ = k6.bwd_occupancy(rows, cols, dtype)
        item = xt.element_size()
        bound = k6.bound_ms(rows, cols, item, "identity")
        bound2 = k6.bound_ms_bwd(rows, cols, item, "identity")
        times[f"bwd_{str(dtype)[6:]}"] = {
            "ms": ms2, "plain_ms": plain2, "library_ms": lib2,
            "bound_ms": bound2, "floor_ms": floor2, "occupancy": occ}
        if dtype == torch.float32:
            times["fwd"] = (ms, plain, lib, host, bound)
            times["bwd"] = (ms2, plain2, lib2, host2, bound2)
            # the library calls compute the same functions (identity case)
            y_lib = F.layer_norm(xt, (cols,), g, b, LN_EPS)
            dx_lib = torch.ops.aten.native_layer_norm_backward(
                dyt, xt, [cols], mu2, rs2, g, b, [True, True, True])[0]
            times["library_max_abs_diff"] = (
                float((y_lib - k6.layer_norm_act(xt, g, b, LN_EPS)[0])
                      .abs().max()),
                float((dx_lib - k6.layer_norm_act_bwd(
                    xt, g, b, mu, rstd, dyt)[0]).abs().max()))
        log(f"[kernel-ln] K6 {str(dtype)[6:]:8s} act=identity rows={rows} "
            f"C={cols} ms={ms:.5f} plain_ms={plain:.5f} bound_ms={bound:.5f} "
            f"(bytes) library_ms={lib:.5f} (F.layer_norm) host_ms={host:.5f}")
        log(f"[kernel-ln-bwd] K7 {str(dtype)[6:]:8s} act=identity rows={rows}"
            f" C={cols} ms={ms2:.5f} plain_ms={plain2:.5f} bound_ms="
            f"{bound2:.5f} (bytes, {bound2 / ms2:.1%} of it) library_ms="
            f"{lib2:.5f} (native_layer_norm_backward) host_ms={host2:.5f}; "
            f"an empty kernel launched the same way {floor2:.5f}; "
            f"{occ['registers']} registers, {occ['smem_bytes']} B shared "
            f"memory, {occ['ctas_per_sm']} CTAs an SM, "
            f"{occ['local_bytes']} B local; layout {occ['layout']}")
        del xt, dyt
    per_call = one_kernel_a_call("K7", LN_SHAPES, "layer_norm_act_bwd")
    log(f"[kernel-ln-bwd] kernels one K7 call launches (torch.profiler, a "
        f"fresh process, {len(LN_SHAPES)} shapes x 3 dtypes), by CTA "
        f"count: {per_call}")
    log(f"[kernel-ln] F.layer_norm and native_layer_norm_backward on the same "
        f"float32 inputs differ from K6's y and K7's dx by at most "
        f"{times['library_max_abs_diff'][0]:.3g} and "
        f"{times['library_max_abs_diff'][1]:.3g}")

    # K1 and K2 with the exact GELU at the path's intermediate width: the
    # 12 bias_act sites of a fused BERT-base forward (and step)
    from deeplearning4j_tpu_torch.kernels import affine_act as k1
    rows1, cols1 = LN_GELU_SHAPE
    xg = torch.randn(rows1, cols1, generator=gen, device=dev)
    dyg = torch.randn(rows1, cols1, generator=gen, device=dev)
    bg = torch.randn(cols1, generator=gen, device=dev)
    # y, dx and dbias against the plain versions in float32 and in the
    # bfloat16 of the fine-tune under set_dtype("BFLOAT16") (the bias stays
    # float32, as bias_act passes it)
    y_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    g_err = {"dx_float32": 0.0, "dx_bfloat16": 0.0, "dscale_dshift": 0.0,
             "dscale_dshift_rel": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        where = f"K1/K2 geluexact {dt} at {LN_GELU_SHAPE}"
        xd, dyd = xg.to(dt), dyg.to(dt)
        check_k1_case(k1, xd, None, bg, "geluexact", where, y_err)
        check_k2_case(k1, xd, None, bg, dyd, "geluexact", where, g_err)
        del xd, dyd
    e1, e2 = y_err[torch.float32], g_err["dx_float32"]
    log(f"[kernel-ln] K1/K2 geluexact at {LN_GELU_SHAPE} against their "
        f"plain versions: max abs err y {e1:.3g}, dx {e2:.3g} (float32); y "
        f"{y_err[torch.bfloat16]:.3g}, dx {g_err['dx_bfloat16']:.3g} "
        f"(bfloat16; ulp_tolerance); dbias {g_err['dscale_dshift']:.3g} "
        f"(K2_SUM_TOL of the column's sum of |term|)")
    ms1, host1 = time_ms(lambda: k1.affine_act(xg, None, bg, "geluexact"))
    plain1, _ = time_ms(
        lambda: k1.affine_act_reference(xg, None, bg, "geluexact"))
    lib1, _ = time_ms(lambda: F.gelu(xg + bg))
    ms2, host2 = time_ms(
        lambda: k1.affine_act_bwd(xg, None, bg, dyg, "geluexact"))
    plain2, _ = time_ms(lambda: k1.affine_act_bwd_reference(
        xg, None, bg, dyg, "geluexact"))
    # bias_act has no scale vector: bytes and operations without it
    bound1 = 1e3 * max(
        k1.bytes_moved(rows1, cols1, 4, has_scale=False) / k1.H100_BYTES_PER_S,
        k1.flops(rows1, cols1, "geluexact", has_scale=False)
        / k1.H100_F32_FLOPS_PER_S)
    gelu = {"fwd": (ms1, plain1, lib1, host1, bound1, e1),
            "bwd": (ms2, plain2, None, host2, k1.bound_ms_bwd(
                rows1, cols1, 4, "geluexact", has_scale=False), e2)}
    log(f"[kernel-ln] K1 geluexact (bias only) rows={rows1} C={cols1}: "
        f"ms={ms1:.5f} plain_ms={plain1:.5f} bound_ms={gelu['fwd'][4]:.5f} "
        f"(bytes) library_ms={lib1:.5f} (F.gelu of x + b) host_ms="
        f"{host1:.5f}; max abs err {e1:.3g}")
    log(f"[kernel-ln-bwd] K2 geluexact (bias only) rows={rows1} C={cols1}: "
        f"ms={ms2:.5f} plain_ms={plain2:.5f} bound_ms={gelu['bwd'][4]:.5f} "
        f"(bytes) library_ms=null host_ms={host2:.5f}; max abs err dx "
        f"{e2:.3g}")
    return {"times": times, "max_err": err, "cases": cases,
            "offset": offset, "gelu": gelu, "bwd_per_call": per_call}


def phase_bert_ln(k1, k3, k6, fa, fe, env) -> dict:
    from deeplearning4j_tpu_torch.models.bert import OUTPUT
    from deeplearning4j_tpu_torch.tools.profile_bert import (
        build, launch_counts, profile, request)
    from deeplearning4j_tpu_torch.utils.convert import samediff_from_numpy
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    sd, reports = build("fusable", seed=0, seq_len=BERT_SEQ)
    att, epi = reports["attention"], reports["epilogues"]
    log(f"[bert-ln] bert_base(spelling='fusable') on cuda, "
        f"{time.perf_counter() - t0:.1f} s; attention {att}; epilogues "
        f"{epi}: {epi.kinds.count('layer_norm')} layer_norm, "
        f"{epi.kinds.count('gelu')} gelu")
    if (att.matched, att.unmatched) != (BERT_LAYERS, 0) or \
            (epi.matched, epi.unmatched) != (LN_SITES + BERT_LAYERS, 0) or \
            epi.kinds.count("layer_norm") != LN_SITES:
        raise AssertionError(f"fusion: {att} {epi} {epi.reasons}")
    per_forward = {"k6": LN_SITES, "k1": BERT_LAYERS, "k3": BERT_LAYERS}
    rng = np.random.default_rng(4)
    feeds = {n: request(rng, n, BERT_SEQ) for n in BERT_REQUESTS}
    for n in BERT_REQUESTS:  # warm-up: cuBLAS handles, allocator pools
        sd.output(feeds[n], [OUTPUT])

    # ---- the fused BERT serving path: counts from 0, read after the last
    k1.launches = k1.bwd_launches = k3.launches = k3.launches_bwd = 0
    k3.launches_dq = k3.launches_dkv = k6.launches = k6.bwd_launches = 0
    fa.reset_counters()
    fe.reset_counters()
    forwards, rows = 0, {}
    for n in BERT_REQUESTS:
        for _ in range(5):
            before = launch_counts()
            y = sd.output(feeds[n], [OUTPUT])[OUTPUT]
            forwards += 1
            got = {k: v - before[k] for k, v in launch_counts().items()
                   if v - before[k]}
            if got != per_forward:
                raise AssertionError(f"request of {n}: launches {got}, "
                                     f"expected {per_forward}")
        if y.shape != (n, BERT_SEQ, 768) or not np.isfinite(y).all():
            raise AssertionError(f"request of {n}: bad output {y.shape}")
        row = profile(sd, feeds[n])
        forwards += 10 + 1 + 3
        rows[n] = row
        log(f"[bert-ln] request of {n:2d} x {BERT_SEQ}: wall "
            f"{row['wall_ms_median']:.3f} ms (median of 10), "
            f"{row['sequences_per_s']:.1f} sequences/s; device "
            f"{row['device_ms']:.3f} ms (busy share "
            f"{row['device_busy_share']:.3f}); K6 {row['k6_device_ms']:.3f} "
            f"ms, K1 {row['k1_device_ms']:.3f} ms, K3 "
            f"{row['k3_device_ms']:.3f} ms per request")
        log("[bert-ln] top kernels (ms per request): " + "; ".join(
            f"{k[:50]} {t:.3f} x{c}" for k, t, c in row["top_kernels_ms"][:5]))
    parity = request(np.random.default_rng(5), 2, BERT_SEQ)
    got = sd.output(parity, [OUTPUT])[OUTPUT]
    forwards += 1
    launches = launch_counts()
    decisions = {"attention": fa.counters(), "epilogues": fe.counters()}
    want = {k: forwards * per_forward.get(k, 0) for k in launches}
    if launches != want or not only_fused(fa, fe) \
            or decisions["attention"]["fused"] != launches["k3"] \
            or decisions["epilogues"]["fused"] != launches["k6"] \
            + launches["k1"]:
        raise AssertionError(f"fused BERT serving path: launches {launches} "
                             f"for {forwards} forwards, decisions "
                             f"{decisions}")

    # the card against the port's plain path on the CPU, same graph
    t0 = time.perf_counter()
    values = {n: sd.get_value(n) for n in sd._values}
    cpu = samediff_from_numpy(sd.to_json(), values, "cpu")
    want_cpu = cpu.output(parity, [OUTPUT])[OUTPUT]
    del cpu
    rel = float(np.abs(got - want_cpu).max() / np.abs(want_cpu).max())
    # the same graph unfused on the card (fuse_attention only): the
    # epilogue decompositions as recorded
    from deeplearning4j_tpu_torch.autodiff.fusion import fuse_attention
    from deeplearning4j_tpu_torch.models.bert import bert_base
    unfused = bert_base(seed=0, device="cuda", seq_len=BERT_SEQ,
                        spelling="fusable")
    fuse_attention(unfused)
    rel_unfused = float(np.abs(got - unfused.output(parity, [OUTPUT])[OUTPUT])
                        .max() / np.abs(want_cpu).max())
    del unfused
    log(f"[bert-ln] card vs CPU plain path, batch 2: max|diff|/max|ref| "
        f"{rel:.3g}; fused vs unfused on the card {rel_unfused:.3g} "
        f"(tolerance {BERT_REL_TOL}; CPU {time.perf_counter() - t0:.1f} s); "
        f"launches {launches} in {forwards} forwards, decisions {decisions}")
    if not (rel <= BERT_REL_TOL and rel_unfused <= BERT_REL_TOL):
        raise AssertionError("fused BERT on the card disagrees with the CPU "
                             "plain path or with the unfused graph")

    # the TF-spelled graph (fuse_attention only) against the fused one on
    # one batch-32 request, in turns: tf, fused, fused, tf
    tf_sd, _ = build("tf", seed=0, seq_len=BERT_SEQ)
    big = feeds[BERT_REQUESTS[-1]]
    tf_sd.output(big, [OUTPUT])
    walls = {"tf": [], "fused": []}
    for tag in ("tf", "fused", "fused", "tf"):
        graph = tf_sd if tag == "tf" else sd
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph.output(big, [OUTPUT])
            walls[tag].append((time.perf_counter() - t0) * 1e3)
    del tf_sd
    ab = {k: statistics.median(v) for k, v in walls.items()}
    log(f"[bert-ln] batch {BERT_REQUESTS[-1]} x {BERT_SEQ}, in turns (tf, "
        f"fused, fused, tf; median of 10 each): tf spelling "
        f"{ab['tf']:.3f} ms, fused {ab['fused']:.3f} ms")
    return {"launches": launches, "forwards": forwards, "rows": rows,
            "rel_err": rel, "rel_err_unfused": rel_unfused, "ab": ab,
            "sd": sd}


def phase_bert_ln_fit(k1, k3, k6, fa, fe, env, sd) -> dict:
    from deeplearning4j_tpu_torch.models.bert import (attach_classifier_head,
                                                      fine_tune_feeds)
    from deeplearning4j_tpu_torch.tools.profile_bert import (launch_counts,
                                                             profile_fit)
    from deeplearning4j_tpu_torch.utils.convert import samediff_from_numpy
    env.Environment.instance().f32_matmul_precision = "highest"
    attach_classifier_head(sd, seed=0)
    names = sd.variables()
    log(f"[bert-ln-fit] the fused graph of [bert-ln] + classifier head: "
        f"{sum(int(sd._values[n].numel()) for n in names)} params in "
        f"{len(names)} VARIABLEs")

    # ---- parity: one batch-2 step on the card vs the CPU plain path ----
    t0 = time.perf_counter()
    parity = fine_tune_feeds(np.random.default_rng(6), FIT_PARITY_BATCH,
                             BERT_SEQ)
    loss_name = sd.loss_name
    loss_g = float(sd.output(parity, [loss_name])[loss_name])
    grads_g = sd.grad(parity)
    values = {n: sd.get_value(n) for n in sd._values}
    cpu = samediff_from_numpy(sd.to_json(), values, "cpu")
    loss_c = float(cpu.output(parity, [loss_name])[loss_name])
    grads_c = cpu.grad(parity)
    cpu._values = {n: t.double() if t.is_floating_point() else t
                   for n, t in cpu._values.items()}
    grads_64 = cpu.grad(parity)
    del cpu, values
    e_loss = abs(loss_g - loss_c) / abs(loss_c)
    worst, bad = (0.0, "", 0.0, 0.0), []
    for n in names:
        e_card = rel_err(grads_g[n], grads_64[n])
        e_cpu = rel_err(grads_c[n], grads_64[n])
        allowed = max(TRAIN_GRAD_TOL, GRAD_NOISE_FACTOR * e_cpu)
        if e_card / allowed >= worst[0]:
            worst = (e_card / allowed, n, e_card, e_cpu)
        if e_card > allowed:
            bad.append(n)
    ln_worst = max((rel_err(grads_g[n], grads_64[n]), n) for n in names
                   if "LayerNorm" in n)
    log(f"[bert-ln-fit] card vs CPU plain path, one batch-{FIT_PARITY_BATCH}"
        f" x {BERT_SEQ} step ({time.perf_counter() - t0:.1f} s): loss "
        f"{loss_g:.6f} vs {loss_c:.6f} (rel err {e_loss:.3g}, tolerance "
        f"{FIT_LOSS_TOL}); against the CPU float64 gradient the worst "
        f"card/allowed ratio is {worst[0]:.3g} at {worst[1]} (card "
        f"{worst[2]:.3g}, CPU float32 {worst[3]:.3g}; allowed "
        f"max({TRAIN_GRAD_TOL}, {GRAD_NOISE_FACTOR} x CPU float32)); the "
        f"LayerNorm gammas and betas (K7's sums) at most {ln_worst[0]:.3g} "
        f"({ln_worst[1]}); {len(names)} VARIABLEs")
    if e_loss > FIT_LOSS_TOL or bad:
        raise AssertionError(f"the fused fine-tune step on the card "
                             f"disagrees with the CPU plain path "
                             f"(gradients out of bounds: {bad})")
    del grads_g, grads_c, grads_64

    # ---- the main path: counts from 0, read after the last fit ----
    feed = fine_tune_feeds(np.random.default_rng(7), FIT_BATCH, BERT_SEQ)
    sd.fit(feed)  # warm-up: cuBLAS handles, allocator pools, the kernels
    k1.launches = k1.bwd_launches = k3.launches = 0
    k3.launches_bwd = k3.launches_dq = k3.launches_dkv = 0
    k6.launches = k6.bwd_launches = 0
    fa.reset_counters()
    fe.reset_counters()
    per_step = {"k1": BERT_LAYERS, "k2": BERT_LAYERS, "k3": BERT_LAYERS,
                "bwd": BERT_LAYERS, "k4": BERT_LAYERS, "k5": BERT_LAYERS,
                "k6": LN_SITES,
                "k7": LN_SITES}
    check = FitLaunchCheck(fa, fe, per_step)
    row = profile_fit(sd, feed, walls=FIT_STEPS - 1, listeners=[check])
    steps = FIT_STEPS + 1 + 3
    launches = launch_counts()
    decisions = {"attention": fa.counters(), "epilogues": fe.counters()}
    copies = (fa.do_copies, fe.dy_copies)
    sentinel = sd.resilience_counters()
    losses = row["losses"]
    log(f"[bert-ln-fit] fit, batch {FIT_BATCH} x {BERT_SEQ}, {FIT_STEPS} "
        f"steps in one call: losses " + " ".join(f"{v:.5f}" for v in losses))
    if launches != {k: steps * v for k, v in per_step.items()} \
            or not only_fused(fa, fe) or sentinel["bad_total"]:
        raise AssertionError(f"fused fine-tune path: launches {launches} "
                             f"for {steps} steps, decisions {decisions}, "
                             f"sentinel {sentinel}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"fine-tune loss not finite and falling: "
                             f"{losses}")
    log(f"[bert-ln-fit] step {row['step_ms_median']:.3f} ms median of "
        f"{FIT_STEPS - 1} ({row['sequences_per_s']:.1f} sequences/s); device "
        f"{row['device_ms']:.3f} ms per step (busy share "
        f"{row['device_busy_share']:.3f}); per step K6 "
        f"{row['k6_device_ms']:.3f}, K7 {row['k7_device_ms']:.3f}, K1 "
        f"{row['k1_device_ms']:.3f}, K2 {row['k2_device_ms']:.3f}, K3 "
        f"{row['k3_device_ms']:.3f}, K4+K5 {row['bwd_device_ms']:.3f} ms; "
        f"launches per step {per_step} in each "
        f"of {steps} steps; decisions {decisions}; do/dy copies {copies}; "
        f"sentinel {sentinel}")
    log("[bert-ln-fit] top kernels (ms per step): " + "; ".join(
        f"{k[:60]} {t:.3f} x{c}" for k, t, c in row["top_kernels_ms"][:6]))
    return {"launches": launches, "steps": steps, "row": row,
            "parity": (e_loss, worst[0]), "copies": copies, "sd": sd}


# ------------------------------------------------- SameDiff import and the
# rest of SameDiff
#: [import]: the committed fixtures' outputs, card against the port's CPU
#: plain path and against the recorded outputs, at the JAX tests'
#: tolerances (tests/test_import_corpus.py; tests/test_import_smoke.py for
#: the smoke fixtures)
IMPORT_RTOL, IMPORT_ATOL = 2e-4, 2e-5
IMPORT_SMOKE_TOL = 1e-4
#: fuse_attention on the imported ONNX transformer block: the JAX
#: package's report (tests/test_torch_onnx_import.py holds the port's to
#: it on the CPU): the export spells k^T as its own transpose, so the
#: chain is refused and K3 does not run there
ONNX_BLOCK_REPORT = (0, 1, ["/Softmax_output_0: scores mmul transpose "
                            "flags are not (False, True)"])
#: [sd-control]: card against the CPU plain path, max |diff| / max |ref|
#: (float32, TF32 off, a few steps of small matmuls)
SD_CONTROL_TOL = 1e-5
#: [bert-bf16-fit]: the fused BERT-base fine-tune under set_dtype
#: ("BFLOAT16"): fit steps on one batch of FIT_BATCH x BERT_SEQ (+1 warm-up
#: and 3 profiled), and the loss gate's steps at FIT_PARITY_BATCH, each
#: loss within BF16_REF_SHARE of the JAX band around the CPU plain path's
#: bf16 loss from the same weights
BERT_BF16_STEPS = 6
BERT_BF16_REF_STEPS = 3
#: The gradient gate of [bert-bf16-fit]: the loss, rounded to bf16 and
#: moved little by 3 Adam(2e-5) steps, does not tell a bf16 step from a
#: float32 one. The first step's gradients at FIT_BATCH x BERT_SEQ do: each
#: VARIABLE's error against the CPU's float64 gradient, over the CPU plain
#: path's bf16 error there, is within BF16_GRAD_FACTOR (no gradient is
#: less accurate than bf16 rounding explains), and the median over the
#: VARIABLEs is at least 1 / BF16_GRAD_FACTOR (the step rounds as bf16
#: does). A VARIABLE whose gradient lies below bf16's rounding (the CPU's
#: bf16 error over 1: attention's key biases, whose true gradient is 0)
#: compares noise with noise, and the card's fused backward rounds
#: otherwise than the plain path: it is held within BF16_NOISE_FACTOR. The
#: card's float32 step, whose errors are four orders below bf16's, must
#: fail the median bound.
BF16_GRAD_FACTOR = 4.0
BF16_NOISE_FACTOR = 8.0
#: [bert-eval]: batches of EVAL_SEQS sequences through SameDiff.evaluate
BERT_EVAL_BATCHES = 3
BERT_EVAL_SEQS = 8
#: [bert-remat]: fit steps a mode takes from the same weights
BERT_REMAT_STEPS = 2


def fixture_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures")


def import_cases() -> list:
    """(name, path, importer kind, feeds, output name, recorded output,
    rtol, atol) for every committed tf_*.pb and onnx_*.onnx fixture."""
    here = fixture_dir()
    smoke = np.load(os.path.join(here, "import_smoke_io.npz"))
    corpus = np.load(os.path.join(here, "import_corpus_io.npz"))
    cases = []
    for path in sorted(os.listdir(here)):
        name, ext = os.path.splitext(path)
        if ext not in (".pb", ".onnx") or not name.startswith(("tf_",
                                                               "onnx_")):
            continue
        kind = "tf" if ext == ".pb" else "onnx"
        if name.endswith("_smoke"):
            io_, key, tol = smoke, kind, (IMPORT_SMOKE_TOL, IMPORT_SMOKE_TOL)
        else:
            io_, key, tol = corpus, name, (IMPORT_RTOL, IMPORT_ATOL)
        x, y = io_[key + "_x"], io_[key + "_y"]
        inp = str(io_[key + "_in"]) if kind == "tf" else "x"
        out = str(io_[key + "_out"]) if kind == "tf" else None
        cases.append((name, os.path.join(here, path), kind, {inp: x}, out,
                      y) + tol)
    return cases


def phase_import(kmods, fa, fe, env) -> dict:
    """[import]: every committed TF and ONNX fixture through the port's
    importers (its own wire reader) on the card: the same records as the
    CPU import, the outputs against the port's CPU plain path and the
    recorded outputs; tf_while.pb's loop on the card; fuse_attention on
    the ONNX transformer block with the JAX package's report; and neither
    TensorFlow, protobuf nor h5py loaded."""
    from deeplearning4j_tpu_torch.autodiff.fusion import fuse_attention
    from deeplearning4j_tpu_torch.modelimport import (
        OnnxFrameworkImporter, TensorflowFrameworkImporter)
    from deeplearning4j_tpu_torch.tools.profile_bert import launch_counts
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    zero_launches(kmods)
    fa.reset_counters()
    fe.reset_counters()
    rows = {}
    for name, path, kind, feeds, out, want, rtol, atol in import_cases():
        def load(device):
            if kind == "tf":
                return TensorflowFrameworkImporter.import_file(
                    path, trainable=True, device=device)
            return OnnxFrameworkImporter.import_file(path, device=device)
        ta = time.perf_counter()
        card = load("cuda")
        import_ms = (time.perf_counter() - ta) * 1e3
        cpu = load("cpu")
        if card.to_json() != cpu.to_json():
            raise AssertionError(f"[import] {name}: the card's records are "
                                 "not the CPU import's")
        o = out or card.onnx_outputs[-1]
        ta = time.perf_counter()
        got = card.output(feeds, [o])[o]
        out_ms = (time.perf_counter() - ta) * 1e3
        ref = cpu.output(feeds, [o])[o]
        e_cpu, e_rec = rel_err(got, ref), rel_err(got.reshape(want.shape),
                                                  want)
        ok = np.allclose(got, ref, rtol=IMPORT_RTOL, atol=IMPORT_ATOL) and \
            np.allclose(got.reshape(want.shape), want, rtol=rtol, atol=atol)
        rows[name] = {"ops": len(card._ops),
                      "variables": len(card.variables()),
                      "rel_err_vs_cpu": e_cpu, "rel_err_vs_recorded": e_rec,
                      "import_ms": import_ms, "output_ms": out_ms,
                      "host_syncs": card.host_syncs}
        log(f"[import] {name}: {len(card._ops)} ops, "
            f"{len(card.variables())} VARIABLEs, imported on cuda in "
            f"{import_ms:.1f} ms; output {o} {tuple(got.shape)} in "
            f"{out_ms:.2f} ms, max|diff|/max|ref| {e_cpu:.3g} against the "
            f"CPU plain path, {e_rec:.3g} against the recorded output "
            f"(rtol {rtol}, atol {atol}); {card.host_syncs} host reads")
        if not ok:
            raise AssertionError(f"[import] {name}: the card's output is "
                                 "out of tolerance")
    if rows["tf_while"]["host_syncs"] < 2:
        raise AssertionError("[import] tf_while.pb did not loop")
    block = OnnxFrameworkImporter.import_file(
        os.path.join(fixture_dir(), "onnx_transformer_block.onnx"),
        device="cuda")
    rep = fuse_attention(block)
    got = (rep.matched, rep.unmatched, list(rep.reasons))
    launches = launch_counts()
    decisions = {"attention": fa.counters(), "epilogues": fe.counters()}
    loaded = [m for m in ("tensorflow", "google.protobuf", "h5py")
              if m in sys.modules]
    log(f"[import] onnx_transformer_block fuse_attention: {rep} "
        f"{rep.reasons} (the JAX package's: {ONNX_BLOCK_REPORT}); kernel "
        f"launches in the phase {launches}, decisions {decisions}; modules "
        f"loaded of tensorflow, google.protobuf, h5py: {loaded}; "
        f"{time.perf_counter() - t0:.1f} s")
    if got != ONNX_BLOCK_REPORT or loaded or not only_fused(fa, fe) \
            or any(launches.values()):
        raise AssertionError(f"[import] report {got}, launches {launches}, "
                             f"decisions {decisions}, loaded {loaded}")
    return {"rows": rows, "launches": launches}


def fit_step_grads(sd, feeds) -> dict:
    """The gradients a ``fit`` step of ``sd`` takes on ``feeds`` under its
    dtype and workspace policy, through the step's own calls (the compute
    copies of the masters, the other values cast, remat), as float64
    numpy arrays keyed by VARIABLE."""
    names = sd.variables()
    carry = sd._fit_carry({n: sd._values[n] for n in names})
    train, copies = carry if isinstance(carry, tuple) else (carry, None)
    other = sd._cast_other_vals({n: v for n, v in sd._values.items()
                                 if n not in names})
    _, grads = sd._value_and_grad(feeds, train, penalty=True, compute=copies,
                                  other=other, remat=True)
    return {n: g.detach().double().cpu().numpy() for n, g in grads.items()}


def bf16_grad_check(grads, cpu_bf16, cpu_f64) -> dict:
    """The gradient gate (BF16_GRAD_FACTOR, BF16_NOISE_FACTOR) over
    ``grads``: each VARIABLE's error against ``cpu_f64`` over
    ``cpu_bf16``'s."""
    e_ref = {n: rel_err(cpu_bf16[n], cpu_f64[n]) for n in cpu_f64}
    r = {n: rel_err(grads[n], cpu_f64[n]) / max(e, 1e-30)
         for n, e in e_ref.items()}
    worst = max((n for n in r if e_ref[n] <= 1.0), key=r.get)
    noise = [r[n] for n in r if e_ref[n] > 1.0]
    med = float(np.median(list(r.values())))
    return {"ok": r[worst] <= BF16_GRAD_FACTOR
            and max(noise, default=0.0) <= BF16_NOISE_FACTOR
            and med >= 1.0 / BF16_GRAD_FACTOR,
            "worst": worst, "worst_ratio": r[worst], "median_ratio": med,
            "least_ratio": min(r.values()), "noise_leaves": len(noise),
            "worst_noise_ratio": max(noise, default=0.0)}


def bf16_launch_counts(kmods) -> dict:
    """The bfloat16 launches, keyed as ``profile_bert.launch_counts``."""
    k1, k3, k6 = kmods["k1"], kmods["k3"], kmods["k6"]
    return {"k1": k1.bf16_launches, "k2": k1.bf16_bwd_launches,
            "k3": k3.bf16_launches, "bwd": k3.bf16_launches_bwd,
            "k6": k6.bf16_launches, "k7": k6.bf16_bwd_launches}


def _control_graph(sd):
    """[sd-control]'s graph: a cond over a captured VARIABLE, a while
    loop, a scan with a carry and per-step outputs, a loss over them
    (tests/test_torch_samediff_controlflow.py's, wider)."""
    rng = np.random.default_rng(11)
    x = sd.placeholder("x")
    p = sd.placeholder("p")
    xs = sd.placeholder("xs")
    w = sd.var("w", (rng.standard_normal((64, 64)) * 0.1).astype(
        np.float32))
    b = sd.var("b", rng.standard_normal(64).astype(np.float32))
    (y,) = sd.cond(p, lambda s, a: s.call("act.tanh", a.mmul(w) + b),
                   lambda s, a: s.call("act.sigmoid", a).mmul(w), x,
                   name="y")
    sd.while_loop(
        lambda s, i, v: s.call("math.less", i, s._lift(np.int32(5))),
        lambda s, i, v: (i + np.int32(1), v * 1.5 - 0.25),
        sd.constant("i0", np.int32(0)), y, name="wl")
    (c,), (h, q) = sd.scan(
        lambda s, c, xt: (s.call("act.tanh", c.mmul(w) + xt),
                          s.call("act.sigmoid", c), c * b),
        [y], [xs], name="sc")
    sd.set_loss(sd.call("math.add",
                        sd.call("reduce.sum", sd.call("math.square", c)),
                        sd.call("reduce.mean", h * q), name="loss"))
    return sd


def phase_sd_control(env) -> dict:
    """[sd-control]: cond, while_loop and scan on the card against the
    CPU plain path: every output, and the gradients through cond and scan,
    for both predicates."""
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    card = _control_graph(SameDiff(device="cuda"))
    cpu = _control_graph(SameDiff(device="cpu"))
    rng = np.random.default_rng(12)
    targets = ["y", "wl__1", "sc", "sc__1", "sc__2", "loss"]
    worst = {}
    for pred in (True, False):
        feeds = {"x": rng.standard_normal((16, 64)).astype(np.float32),
                 "p": np.array(pred),
                 "xs": rng.standard_normal((12, 16, 64)).astype(
                     np.float32)}
        got, want = card.output(feeds, targets), cpu.output(feeds, targets)
        for t in targets:
            worst[f"{t}/{pred}"] = rel_err(got[t], want[t])
        g, gw = card.grad(feeds), cpu.grad(feeds)
        for n in g:
            worst[f"d{n}/{pred}"] = rel_err(g[n], gw[n])
    bad = {k: v for k, v in worst.items() if not v <= SD_CONTROL_TOL}
    top = max(worst, key=worst.get)
    log(f"[sd-control] cond, while_loop and scan on cuda against the CPU "
        f"plain path, both predicates: worst max|diff|/max|ref| "
        f"{worst[top]:.3g} at {top} (tolerance {SD_CONTROL_TOL}); "
        f"{card.host_syncs} host reads of predicates; "
        f"{time.perf_counter() - t0:.1f} s")
    if bad or card.host_syncs != cpu.host_syncs:
        raise AssertionError(f"[sd-control] out of tolerance: {bad}")
    return {"worst": worst[top], "host_syncs": card.host_syncs}


def phase_bert_bf16_fit(kmods, fa, fe, env, sd, f32_row) -> dict:
    """[bert-bf16-fit]: the fused BERT-base fine-tune of [bert-ln-fit]
    (its weights after that phase) through ``SameDiff.fit`` under
    ``set_dtype("BFLOAT16")``: the first step's gradients at FIT_BATCH x
    BERT_SEQ by the gradient gate (BF16_GRAD_FACTOR), which the card's
    float32 step must fail; the first BERT_BF16_REF_STEPS losses at
    batch FIT_PARITY_BATCH within BF16_REF_SHARE of the JAX bf16 band
    around the CPU plain path's bf16 losses from the same weights; one
    ``fused_updater`` decision; then fit steps at FIT_BATCH x BERT_SEQ from
    0-set counts, each with 12 K1, 12 K2, 12 K3, 12 K4+K5, 25 K6 and 25 K7
    launches, all in bfloat16, only ``fused`` decisions; masters float32;
    step and device ms, the kernels' device ms beside [bert-ln-fit]'s
    float32, and the device kernels of one bf16 and one float32 step in a
    fresh process."""
    from deeplearning4j_tpu_torch.models.bert import fine_tune_feeds
    from deeplearning4j_tpu_torch.tools import count_kernels
    from deeplearning4j_tpu_torch.tools.profile_bert import (launch_counts,
                                                             profile_fit)
    from deeplearning4j_tpu_torch.utils.convert import samediff_from_numpy
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    start, it0 = clone_tree(sd._values), sd.iteration
    values = {n: sd.get_value(n) for n in sd._values}
    feed = fine_tune_feeds(np.random.default_rng(7), FIT_BATCH, BERT_SEQ)
    # ---- the gradient gate: the main path's first step, bf16 on the card
    # and float32 (the control) against the CPU's bf16 and float64 ----
    cpu = samediff_from_numpy(sd.to_json(), values, "cpu")
    cpu.set_dtype("BFLOAT16")
    g_bf16 = fit_step_grads(cpu, feed)
    cpu._values = {n: t.double() if t.is_floating_point() else t
                   for n, t in cpu._values.items()}
    cpu.set_dtype("FLOAT")
    g_64 = {n: np.asarray(g, np.float64) for n, g in cpu.grad(feed).items()}
    cpu_grad_s = time.perf_counter() - t0
    del cpu
    sd.set_dtype("BFLOAT16")
    grad_gate = bf16_grad_check(fit_step_grads(sd, feed), g_bf16, g_64)
    sd.set_dtype("FLOAT")
    grad_f32 = bf16_grad_check(fit_step_grads(sd, feed), g_bf16, g_64)
    del g_bf16, g_64
    log(f"[bert-bf16-fit] first-step gradients at {FIT_BATCH} x {BERT_SEQ} "
        f"against the CPU's float64, over the CPU plain path's bf16 error "
        f"({cpu_grad_s:.1f} s): card bf16 worst {grad_gate['worst_ratio']:.3g}"
        f" at {grad_gate['worst']}, median {grad_gate['median_ratio']:.3g}, "
        f"least {grad_gate['least_ratio']:.3g}, worst of the "
        f"{grad_gate['noise_leaves']} below bf16's rounding "
        f"{grad_gate['worst_noise_ratio']:.3g}; card float32 (the control) "
        f"median {grad_f32['median_ratio']:.3g}, worst "
        f"{grad_f32['worst_ratio']:.3g}; gate: worst <= {BF16_GRAD_FACTOR} "
        f"({BF16_NOISE_FACTOR} below bf16's rounding), median >= "
        f"{1 / BF16_GRAD_FACTOR}")
    if not grad_gate["ok"] or grad_f32["ok"]:
        raise AssertionError(f"[bert-bf16-fit] gradient gate: bf16 "
                             f"{grad_gate}, float32 control {grad_f32} (it "
                             f"must fail)")
    # ---- the loss gate: card and CPU, bf16, from the same weights and
    # step count (Adam's bias correction reads it) ----
    parity = fine_tune_feeds(np.random.default_rng(6), FIT_PARITY_BATCH,
                             BERT_SEQ)
    cpu = samediff_from_numpy(sd.to_json(), values, "cpu")
    del values
    cpu.set_dtype("BFLOAT16")
    cpu.iteration = sd.iteration = 0
    t1 = time.perf_counter()
    cpu_losses = cpu.fit(parity, epochs=BERT_BF16_REF_STEPS).losses
    cpu_s = time.perf_counter() - t1
    del cpu
    f32_losses = sd.fit(parity, epochs=BERT_BF16_REF_STEPS).losses
    sd._values.update(clone_tree(start))
    sd.iteration = 0
    sd.set_dtype("BFLOAT16")
    fe.reset_counters()
    card_losses = sd.fit(parity, epochs=BERT_BF16_REF_STEPS).losses
    upd = fe.updater_counters()
    share = band_shares(card_losses, cpu_losses)
    f32_share = band_shares(f32_losses, cpu_losses)
    log(f"[bert-bf16-fit] batch {FIT_PARITY_BATCH} x {BERT_SEQ}, "
        f"{BERT_BF16_REF_STEPS} steps: card bf16 losses "
        + " ".join(f"{v:.5f}" for v in card_losses) + ", CPU plain path "
        f"bf16 ({cpu_s:.1f} s) " + " ".join(f"{v:.5f}" for v in cpu_losses)
        + ", card float32 " + " ".join(f"{v:.5f}" for v in f32_losses)
        + f"; worst share of the JAX band (rtol {BF16_RTOL}, atol "
        f"{BF16_ATOL}) around the CPU's bf16 losses {max(share):.3g} (gate "
        f"{BF16_REF_SHARE}), float32's {max(f32_share):.3g}; updater "
        f"{upd}")
    if max(share) > BF16_REF_SHARE or upd != {
            "fused_updater": 1, "fallback_updater_dtype": 0,
            "fallback_updater_penalty": 0}:
        raise AssertionError("[bert-bf16-fit] losses leave the CPU plain "
                             "path's bf16 band, or the updater's route")
    sd._values.update(clone_tree(start))

    # ---- the main path: counts from 0, read after the last fit ----
    sd.fit(feed)  # warm-up: the bf16 kernels and the allocator's pools
    zero_launches(kmods)
    fa.reset_counters()
    fe.reset_counters()
    per_step = {"k1": BERT_LAYERS, "k2": BERT_LAYERS, "k3": BERT_LAYERS,
                "bwd": BERT_LAYERS, "k4": BERT_LAYERS, "k5": BERT_LAYERS,
                "k6": LN_SITES, "k7": LN_SITES}
    check = FitLaunchCheck(fa, fe, per_step)
    row = profile_fit(sd, feed, walls=BERT_BF16_STEPS - 1, listeners=[check])
    steps = BERT_BF16_STEPS + 1 + 3
    launches, bf16 = launch_counts(), bf16_launch_counts(kmods)
    losses = row["losses"]
    masters = {str(sd._values[n].dtype) for n in sd.variables()}
    log(f"[bert-bf16-fit] fit, batch {FIT_BATCH} x {BERT_SEQ}, "
        f"{BERT_BF16_STEPS} steps in one call: losses "
        + " ".join(f"{v:.5f}" for v in losses))
    if launches != {k: steps * v for k, v in per_step.items()} or \
            any(bf16[k] != launches[k] for k in bf16) or \
            not only_fused(fa, fe) or masters != {"torch.float32"} or \
            not all(np.isfinite(losses)):
        raise AssertionError(f"[bert-bf16-fit] launches {launches} (bf16 "
                             f"{bf16}) for {steps} steps, decisions "
                             f"{fa.counters()} {fe.counters()}, masters "
                             f"{masters}, losses {losses}")
    t1 = time.perf_counter()
    counted = count_kernels.count_in_subprocess(
        [["bert_fit", [FIT_BATCH, BERT_SEQ], dt]
         for dt in ("bfloat16", "float32")])
    kernels, kernels_f32 = (sum(c[4].values()) for c in counted)
    split = {k: row[f"{k}_device_ms"] for k in ("k1", "k2", "k3", "bwd",
                                                 "k6", "k7")}
    f32 = {k: f32_row[f"{k}_device_ms"] for k in split}
    bounds = bert_bf16_bounds(kmods["k1"], kmods["k3"], kmods["k6"])
    log(f"[bert-bf16-fit] step {row['step_ms_median']:.3f} ms median of "
        f"{BERT_BF16_STEPS - 1} ({row['sequences_per_s']:.1f} sequences/s; "
        f"[bert-ln-fit] float32 {f32_row['step_ms_median']:.3f}); device "
        f"{row['device_ms']:.3f} ms a step (busy share "
        f"{row['device_busy_share']:.3f}; float32 {f32_row['device_ms']:.3f}"
        f"); bf16 against float32 ms a step (bf16 bound): " + ", ".join(
            f"{k} {split[k]:.4f}/{f32[k]:.4f} ({bounds[k]['ms']:.4f}, "
            f"{bounds[k]['by']})" for k in split)
        + f"; {kernels} device kernels a step ({kernels_f32} in float32; "
        f"a fresh process, {time.perf_counter() - t1:.1f} s); {per_step} "
        f"bf16 launches in "
        f"each of {steps} steps; {time.perf_counter() - t0:.1f} s")
    sd.set_dtype("FLOAT")
    sd._values.update(clone_tree(start))
    sd.iteration = it0
    return {"launches": launches, "bf16": bf16, "steps": steps, "row": row,
            "ref_share": max(share), "f32_ref_share": max(f32_share),
            "grad_gate": grad_gate, "grad_f32_control": grad_f32,
            "cpu_losses": cpu_losses, "card_losses": card_losses,
            "kernels_per_step": kernels, "kernels_per_step_f32": kernels_f32,
            "split": split, "f32_split": f32,
            "bounds": bounds}


def bert_bf16_bounds(k1, k3, k6) -> dict:
    """The least time, ms a bfloat16 fused BERT-base fine-tune step at
    FIT_BATCH x BERT_SEQ, of each kernel's calls: the larger of the 2-byte
    traffic over the memory rate and the operations over the dense 16-bit
    tensor-core rate, with ``bytes`` or ``operations``."""
    rows, mem, ops = FIT_BATCH * BERT_SEQ, k1.H100_BYTES_PER_S, \
        k1.H100_16BIT_FLOPS_PER_S
    hd = 768 // 12

    def bound(calls, nbytes, nops):
        t_b, t_o = nbytes / mem, nops / ops
        return {"ms": 1e3 * calls * max(t_b, t_o),
                "by": "bytes" if t_b >= t_o else "operations"}
    r, c = LN_GELU_SHAPE
    out = {"k1": bound(BERT_LAYERS, k1.bytes_moved(r, c, 2, False),
                       k1.flops(r, c, "geluexact", False)),
           "k2": bound(BERT_LAYERS, k1.bytes_moved_bwd(r, c, 2, False),
                       k1.flops_bwd(r, c, "geluexact", False)),
           "k3": bound(BERT_LAYERS, k3.bytes_moved(
               FIT_BATCH, 12, BERT_SEQ, BERT_SEQ, hd, 2),
               k3.flops(FIT_BATCH, 12, BERT_SEQ, BERT_SEQ, hd)),
           "bwd": bound(BERT_LAYERS, k3.bytes_moved_bwd(
               FIT_BATCH, 12, BERT_SEQ, BERT_SEQ, hd, 2, "fused"),
               k3.flops_bwd(FIT_BATCH, 12, BERT_SEQ, BERT_SEQ, hd,
                            "fused")),
           "k6": bound(LN_SITES, k6.bytes_moved(rows, 768, 2),
                       k6.flops(rows, 768, "identity")),
           "k7": bound(LN_SITES, k6.bytes_moved_bwd(rows, 768, 2),
                       k6.flops_bwd(rows, 768, "identity"))}
    return out


def phase_bert_remat(kmods, fa, fe, env, sd) -> dict:
    """[bert-remat]: the same fused BERT-base, float32, under workspace
    modes "none" (three times), "full" and "every_4", each BERT_REMAT_STEPS fit
    steps from the same weights and 0-set counts, under deterministic
    algorithms (the embedding gradient's atomics otherwise move the last
    bits from run to run, and three runs' spread is too small a sample
    of that noise: the rule failed on a candidate 8x a spread of 2.3e-10
    where the usual spread is 7.5e-9): the K1, K3 and K6
    launches twice a forward's under remat (every segment is recomputed in
    the backward), K2, K4+K5 and K7 a step's, only ``fused`` decisions;
    the losses and new values of each mode against the "none" runs by the
    determinism rule (``spread_check_many``); the peak memory of the steps ("full" below
    "none"), and memory_report's residual bytes and segment count."""
    from deeplearning4j_tpu_torch.autodiff import remat
    from deeplearning4j_tpu_torch.models.bert import fine_tune_feeds
    from deeplearning4j_tpu_torch.nn import memory
    from deeplearning4j_tpu_torch.tools.profile_bert import launch_counts
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    start, it0 = clone_tree(sd._values), sd.iteration
    feed = fine_tune_feeds(np.random.default_rng(8), FIT_BATCH, BERT_SEQ)
    rows, runs = {}, {}
    modes = (("none", "none"), ("none_2", "none"), ("none_3", "none"),
             ("full", "full"), ("every_4", "every_4"))
    with Deterministic():
        for tag, mode in modes:
            sd._values.update(clone_tree(start))
            sd.iteration = it0
            sd.set_workspace_mode(mode)
            zero_launches(kmods)
            fa.reset_counters()
            fe.reset_counters()
            hist = []
            peak = peak_bytes(lambda: hist.append(
                sd.fit(feed, epochs=BERT_REMAT_STEPS).losses))
            launches = launch_counts()
            fused = only_fused(fa, fe)
            runs[tag] = flat(torch.tensor(hist[0]),
                             {n: sd._values[n] for n in sd.variables()})
            rep = sd.memory_report(feed)
            policy = memory.resolve_policy(mode)
            segments = len(remat.segment_bounds(sd, policy)) \
                if policy.remat else 0
            twice = 2 if policy.remat else 1
            want = {"k1": twice * BERT_LAYERS, "k2": BERT_LAYERS,
                    "k3": twice * BERT_LAYERS, "bwd": BERT_LAYERS,
                    "k4": BERT_LAYERS, "k5": BERT_LAYERS,
                    "k6": twice * LN_SITES, "k7": LN_SITES}
            rows[tag] = {"mode": mode, "peak_bytes": peak,
                         "residual_bytes": rep["residual_bytes"],
                         "activation_bytes": rep["activation_bytes"],
                         "segments": segments, "losses": hist[0],
                         "launches": launches}
            log(f"[bert-remat] {tag}: losses "
                + " ".join(f"{v:.6f}" for v in hist[0])
                + f"; peak {peak / 2**20:.1f} MiB over {BERT_REMAT_STEPS} "
                f"fit steps; memory_report residual "
                f"{rep['residual_bytes'] / 2**20:.1f} MiB (activations "
                f"{rep['activation_bytes'] / 2**20:.1f}), {segments} "
                f"segments; launches {launches}")
            per_fit = {k: BERT_REMAT_STEPS * v for k, v in want.items()}
            if launches != per_fit or not fused:
                raise AssertionError(
                    f"[bert-remat] {tag}: launches {launches}, expected "
                    f"{want} a step; decisions {fa.counters()} "
                    f"{fe.counters()}")
    refs = [runs[t] for t in ("none", "none_2", "none_3")]
    checks = {m: spread_check_many(refs, runs[m],
                                   f"[bert-remat] {m} losses and values")
              for m in ("full", "every_4")}
    log(f"[bert-remat] against three \"none\" runs: " + "; ".join(
        f"{m} {c['rule']} (runs {c['reference_spread']:.3g} apart, "
        f"candidate {c['candidate_diff']:.3g})" for m, c in checks.items())
        + f"; {time.perf_counter() - t0:.1f} s")
    if not rows["full"]["peak_bytes"] < rows["none"]["peak_bytes"]:
        raise AssertionError("[bert-remat] \"full\" does not hold less than "
                             "\"none\" at its peak")
    sd.set_workspace_mode("none")
    sd._values.update(clone_tree(start))
    sd.iteration = it0
    return {"rows": rows, "checks": checks}


def phase_bert_eval(kmods, fa, fe, env, sd) -> dict:
    """[bert-eval]: ``SameDiff.evaluate`` of the fused BERT-base
    classifier (its logits) over BERT_EVAL_BATCHES seeded batches of
    BERT_EVAL_SEQS x BERT_SEQ on the card, 12 K1, 12 K3 and 25 K6 a
    forward, only ``fused`` decisions; its confusion matrix the CPU plain
    path's up to near-ties (``check_confusion``)."""
    from deeplearning4j_tpu_torch.models.bert import LABELS, fine_tune_feeds
    from deeplearning4j_tpu_torch.tools.profile_bert import launch_counts
    from deeplearning4j_tpu_torch.utils.convert import samediff_from_numpy
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    loss = next(r for r in sd._ops if sd.loss_name in r.outputs)
    logits = loss.inputs[1]
    rng = np.random.default_rng(9)
    batches = []
    for _ in range(BERT_EVAL_BATCHES):
        f = fine_tune_feeds(rng, BERT_EVAL_SEQS, BERT_SEQ)
        labels = f.pop(LABELS)
        batches.append((f, labels))
    zero_launches(kmods)
    fa.reset_counters()
    fe.reset_counters()
    ev = sd.evaluate(batches, logits)
    launches = launch_counts()
    want = {"k1": BERT_LAYERS, "k2": 0, "k3": BERT_LAYERS, "bwd": 0,
            "k4": 0, "k5": 0, "k6": LN_SITES, "k7": 0}
    if launches != {k: BERT_EVAL_BATCHES * v for k, v in want.items()} \
            or not only_fused(fa, fe):
        raise AssertionError(f"[bert-eval] launches {launches} for "
                             f"{BERT_EVAL_BATCHES} forwards, decisions "
                             f"{fa.counters()} {fe.counters()}")
    cpu = samediff_from_numpy(sd.to_json(), {
        n: sd.get_value(n) for n in sd._values}, "cpu")
    t1 = time.perf_counter()
    cpu_ev = cpu.evaluate(batches, logits)
    cpu_out = np.concatenate([cpu.output(f, [logits])[logits]
                              for f, _ in batches])
    cpu_s = time.perf_counter() - t1
    labels = np.concatenate([y for _, y in batches])
    moved = check_confusion(ev.confusion, cpu_ev.confusion, labels, cpu_out,
                            "[bert-eval]")
    log(f"[bert-eval] evaluate on {BERT_EVAL_BATCHES} batches of "
        f"{BERT_EVAL_SEQS} x {BERT_SEQ}: accuracy {ev.accuracy():.4f} "
        f"(CPU plain path {cpu_ev.accuracy():.4f}, {cpu_s:.1f} s), confusion "
        f"{ev.confusion.tolist()} (CPU {cpu_ev.confusion.tolist()}; {moved} "
        f"counts moved by near-ties); launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "accuracy": ev.accuracy(),
            "accuracy_cpu": cpu_ev.accuracy(), "ties": moved}


# ---- Keras import (phases 30-32) -------------------------------------------

KERAS_FILES = ("keras_smoke.h5", "keras_lstm.h5", "keras_bigru.h5",
               "keras_sepdw.h5", "keras_v3_lstm.keras",
               "keras_v3_lstm_dropout.keras")
#: K1 launches of one forward (tests/test_torch_keras_import.py holds the
#: same counts against the JAX package's epilogue dispatches): the Conv2D
#: bias + ReLU and the BatchNormalization of keras_smoke.h5; none in
#: keras_sepdw.h5, whose separable and depthwise convolutions apply their
#: activation outside the epilogue, as in the JAX package
KERAS_K1_PER_FORWARD = {"keras_smoke.h5": 2, "keras_sepdw.h5": 0}
#: K8 launches of one keras_lstm.h5 request once its LSTMs opt in with
#: use_pallas_cell=True: 2 layers x the engine's time bucket (8) for the
#: recorded input's 6 steps
KERAS_LSTM_K8 = 16
#: K1/K2 a step of the golden replay
KERAS_GOLDEN_K = (2, 2)
#: the Keras ResNet-50: K1 a forward (53 Conv2D bias epilogues + 53
#: BatchNormalizations) and K2 a fine-tune step (every one trainable)
KERAS_RN50_K1 = 106
KERAS_RN50_K2 = 106
KERAS_RN50_BATCH = 32
KERAS_RN50_REQUESTS = 5
KERAS_RN50_STEPS = 3
KERAS_RN50_LR = 0.01
#: the first fine-tune step's loss on the card (float32, TF32 off) against
#: the CPU plain path's float64 loss on the same weights and batch
KERAS_RN50_LOSS_TOL = 1e-3
#: The fine-tune's gradients at batch PARITY_BATCH go by [train]'s float64
#: rule. Each Conv2D bias feeds a training-mode BatchNormalization, whose
#: batch mean takes the bias out: its exact gradient is 0, and the CPU's
#: float64 one is rounding (~1e-13) beside float32's (~1e-4; 32x32 CPU
#: runs of this net). Such a leaf (CPU float32 error >= 1 against float64)
#: holds only rounding, and the card's K2 column sum must stay within this
#: factor of the CPU float32's. A bias gradient summed over wrong rows or
#: channels is of the weight gradients' scale, far above both.
KERAS_RN50_ZERO_GRAD_FACTOR = 10.0


def keras_io(name):
    """(input, recorded output, rtol, atol) of a committed Keras fixture."""
    here = fixture_dir()
    stem = name.rsplit(".", 1)[0]
    if stem == "keras_smoke":
        z = np.load(os.path.join(here, "import_smoke_io.npz"))
        return (z["keras_x"], z["keras_y"], IMPORT_SMOKE_TOL,
                IMPORT_SMOKE_TOL)
    z = np.load(os.path.join(here, "import_corpus_io.npz"))
    return z[stem + "_x"], z[stem + "_y"], IMPORT_RTOL, IMPORT_ATOL


def oracles_loaded() -> list:
    return [m for m in ("h5py", "keras", "tensorflow") if m in sys.modules]


def phase_keras_import(kmods, fe, env) -> dict:
    """[keras-import]: every committed Keras fixture through the port's
    HDF5 reader and ``KerasModelImport`` on the card, against the CPU
    import and the recorded outputs; the K1 and K8 counts of the path."""
    from deeplearning4j_tpu_torch.modelimport import KerasModelImport
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    zero_launches(kmods)
    fe.reset_counters()
    rows, nets = {}, {}
    for name in KERAS_FILES:
        path = os.path.join(fixture_dir(), name)
        ta = time.perf_counter()
        card = KerasModelImport.import_keras_model_and_weights(
            path, device="cuda")
        import_ms = (time.perf_counter() - ta) * 1e3
        cpu = KerasModelImport.import_keras_model_and_weights(
            path, device="cpu")
        if card.conf.to_json() != cpu.conf.to_json():
            raise AssertionError(f"[keras-import] {name}: the card's "
                                 "configuration is not the CPU import's")
        x, want, rtol, atol = keras_io(name)
        before = kernel_launches(kmods)
        ta = time.perf_counter()
        got = card.output(x)
        out_ms = (time.perf_counter() - ta) * 1e3
        after = kernel_launches(kmods)
        per = {k: after[k] - before[k] for k in after}
        ref = cpu.output(x)
        ok = np.allclose(got, ref, rtol=IMPORT_RTOL, atol=IMPORT_ATOL) and \
            np.allclose(got, want, rtol=rtol, atol=atol)
        n_params = sum(t.numel() for t in flat_leaves(card.params))
        rows[name] = {"params": n_params,
                      "kind": type(card).__name__, "import_ms": import_ms,
                      "output_ms": out_ms, "k1": per["k1"], "k8": per["k8"],
                      "rel_err_vs_cpu": rel_err(got, ref),
                      "rel_err_vs_recorded": rel_err(got, want)}
        log(f"[keras-import] {name}: {type(card).__name__} of "
            f"{len(card.conf.to_json())} config bytes and {n_params} "
            f"parameter values imported on cuda through the port's HDF5 "
            f"reader in {import_ms:.1f} ms; output "
            f"{tuple(got.shape)} in {out_ms:.2f} ms, rel err "
            f"{rows[name]['rel_err_vs_cpu']:.3g} against the CPU plain "
            f"path, {rows[name]['rel_err_vs_recorded']:.3g} against the "
            f"recorded output (rtol {rtol}, atol {atol}); K1 {per['k1']}, "
            f"K8 {per['k8']} launches")
        if not ok:
            raise AssertionError(f"[keras-import] {name}: the card's output "
                                 "is out of tolerance")
        if per["k8"] or per["k1"] != KERAS_K1_PER_FORWARD.get(name,
                                                              per["k1"]):
            raise AssertionError(f"[keras-import] {name}: launches {per}")
        nets[name] = card
    # an imported LSTM runs the plain cell; opted in, K8 at every step
    net = nets["keras_lstm.h5"]
    lstm = [l for l in net.conf.layers if l.kind == "lstm"]
    for l in lstm:
        l.use_pallas_cell = True
    x, want, rtol, atol = keras_io("keras_lstm.h5")
    before = kernel_launches(kmods)["k8"]
    got = net.output(x)
    k8 = kernel_launches(kmods)["k8"] - before
    log(f"[keras-import] keras_lstm.h5 with use_pallas_cell=True on its "
        f"{len(lstm)} LSTMs: {k8} K8 launches a request (expected "
        f"{KERAS_LSTM_K8}), rel err {rel_err(got, want):.3g} against the "
        "recorded output")
    if k8 != KERAS_LSTM_K8 or not np.allclose(got, want, rtol=rtol,
                                              atol=atol):
        raise AssertionError(f"[keras-import] pallas LSTM: {k8} K8 launches")
    launches = kernel_launches(kmods)
    loaded = oracles_loaded()
    decisions = fe.counters()
    log(f"[keras-import] launches in the phase {launches}; epilogue "
        f"decisions {decisions}; modules loaded of h5py, keras, tensorflow: "
        f"{loaded}; {time.perf_counter() - t0:.1f} s")
    others = {k: v for k, v in launches.items() if k not in ("k1", "k8")}
    if loaded or any(others.values()) or \
            decisions["fused"] != launches["k1"]:
        raise AssertionError(f"[keras-import] launches {launches}, "
                             f"decisions {decisions}, loaded {loaded}")
    return {"rows": rows, "launches": launches}


def phase_keras_golden(kmods, fe, env) -> dict:
    """[keras-golden]: ``golden_harness.run_keras_imported`` on the card
    (``tools/keras_golden.py``), held to ``keras_imported_golden.json`` at
    ``golden_harness.compare``'s bands."""
    from deeplearning4j_tpu_torch.tools import keras_golden as kg
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    net = kg.golden_net(device="cuda")
    per_step, last = [], {}

    def count():
        now = kernel_launches(kmods)
        per_step.append((now["k1"] - last["k1"], now["k2"] - last["k2"]))
        last.update(now)

    zero_launches(kmods)
    fe.reset_counters()
    last.update(kernel_launches(kmods))
    snap = kg.replay(net, on_step=count)
    launches = kernel_launches(kmods)
    with open(kg.GOLDEN) as f:
        golden = json.load(f)
    worst = kg.band_share(snap, golden)
    losses = snap["losses"]
    log(f"[keras-golden] {kg.STEPS} Sgd({kg.LEARNING_RATE}) steps of batch "
        f"{kg.BATCH} on the card: losses "
        + " ".join(f"{v:.6f}" for v in losses) + "; the golden's "
        + " ".join(f"{v:.6f}" for v in golden["losses"])
        + f"; worst |diff| / (atol + rtol |golden|) over the losses and "
        f"{len(golden['params'])} parameter summaries {worst:.3g} (must be "
        f"<= 1; rtol {kg.RTOL}, atol {kg.ATOL}); K1/K2 a step "
        f"{sorted(set(per_step))}; {time.perf_counter() - t0:.1f} s")
    if worst > 1:
        raise AssertionError("[keras-golden] the card leaves the golden's "
                             "bands")
    if set(per_step) != {KERAS_GOLDEN_K} or any(
            v for k, v in launches.items() if k not in ("k1", "k2")):
        raise AssertionError(f"[keras-golden] launches {per_step}, "
                             f"{launches}")
    return {"launches": launches, "worst_band_share": worst,
            "losses": losses}


def keras_rn50_batch(rng, n):
    """A batch of ``n`` random 224x224x3 images with one-hot labels."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    x = rng.standard_normal((n, 224, 224, 3), dtype=np.float32)
    return DataSet(x, np.eye(1000, dtype=np.float32)[rng.integers(0, 1000,
                                                                  n)])


def phase_keras_resnet50(kmods, fe, env, graph) -> dict:
    """[keras-resnet50]: the Keras ResNet-50 configuration imported with
    seeded Keras-layout weights, served at batch 32 and fine-tuned."""
    from deeplearning4j_tpu_torch.nn.layers.core import OutputLayer
    from deeplearning4j_tpu_torch.nn.transfer import (FineTuneConfiguration,
                                                      TransferLearning)
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    from deeplearning4j_tpu_torch.tools import make_keras_config as mk
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    net = mk.import_resnet50(device="cuda", seed=0)
    import_s = time.perf_counter() - t0
    fold, skip = net._epilogue_fold_plan()
    n_params = sum(t.numel() for p in net.params.values()
                   for t in p.values())
    log(f"[keras-resnet50] imported on cuda in {import_s:.1f} s: "
        f"{len(net.conf.vertices)} vertices, {n_params} parameters, "
        f"{len(fold)} BN + activation pairs folded ({len(skip)} activation "
        "vertices pass through)")
    rng = np.random.default_rng(11)
    x = rng.standard_normal((KERAS_RN50_BATCH, 224, 224, 3),
                            dtype=np.float32)
    net.output(x)  # the engine's first call at this bucket
    torch.cuda.synchronize()

    # ---- serve: counts from 0, read after the requests ----
    zero_launches(kmods)
    fe.reset_counters()
    ts = []
    for _ in range(KERAS_RN50_REQUESTS):
        t1 = time.perf_counter()
        y = net.output(x)
        ts.append((time.perf_counter() - t1) * 1e3)
    serve = kernel_launches(kmods)
    latency = statistics.median(ts)
    if y.shape != (KERAS_RN50_BATCH, 1000) or not np.isfinite(y).all() or \
            not np.allclose(y.sum(axis=1), 1.0, atol=1e-4):
        raise AssertionError(f"[keras-resnet50] bad output {y.shape}")
    log(f"[keras-resnet50] {KERAS_RN50_REQUESTS} requests of "
        f"{KERAS_RN50_BATCH} images: median {latency:.3f} ms "
        f"({KERAS_RN50_BATCH * 1e3 / latency:.1f} images/s); launches "
        f"{serve}")
    if serve["k1"] != KERAS_RN50_REQUESTS * KERAS_RN50_K1 or any(
            v for k, v in serve.items() if k != "k1"):
        raise AssertionError(f"[keras-resnet50] serving launches {serve}")

    # ---- the card against the CPU plain path, batch 2 ----
    cpu = cpu_twin(graph, net)
    x2 = x[:2]
    e_out = rel_err(net.output(x2), cpu.output(x2))
    e_pool = rel_err(net.feed_forward(x2)["avg_pool"].cpu().numpy(),
                     cpu.feed_forward(x2)["avg_pool"].numpy())
    log(f"[keras-resnet50] card vs CPU plain path, batch 2: output rel err "
        f"{e_out:.3g}, avg_pool rel err {e_pool:.3g} (tolerance "
        f"{CPU_REL_TOL})")
    if not (e_out <= CPU_REL_TOL and e_pool <= CPU_REL_TOL):
        raise AssertionError("[keras-resnet50] the card disagrees with the "
                             "CPU plain path")
    del cpu

    # ---- fine-tune: the Dense head re-headed as an OutputLayer ----
    new = (TransferLearning.GraphBuilder(net)
           .fine_tune_configuration(FineTuneConfiguration(
               updater=Sgd(learning_rate=KERAS_RN50_LR)))
           .remove_vertex("predictions")
           .add_layer("predictions", OutputLayer(n_out=1000), "avg_pool")
           .set_outputs("predictions").build())
    new.params["predictions"] = {k: t.clone() for k, t in
                                 net.params["predictions"].items()}
    new.updater_state = new.conf.updater.init_state(new.params)
    del net
    batches = [keras_rn50_batch(rng, KERAS_RN50_BATCH)
               for _ in range(KERAS_RN50_STEPS)]
    twin = cpu_twin(graph, new, "DOUBLE", lambda t: t.double())

    # ---- the first batch's gradients by [train]'s float64 rule ----
    t1 = time.perf_counter()
    x4 = batches[0].features[:PARITY_BATCH]
    y4 = batches[0].labels[:PARITY_BATCH]
    loss_g, g_card = graph_loss_grads(env, new, x4, y4)
    loss_c, g_cpu = graph_loss_grads(env, cpu_twin(graph, new), x4, y4)
    _, g_64 = graph_loss_grads(env, twin, x4.astype(np.float64),
                               y4.astype(np.float64))
    e_loss4 = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    rows = grad_ratios([g_card], [g_cpu], [g_64], (),
                       KERAS_RN50_ZERO_GRAD_FACTOR)
    zero = [r for r in rows if r[3] >= 1.0]
    plain = [r for r in rows if r[3] < 1.0]
    log(f"[keras-resnet50] batch-{PARITY_BATCH} gradients of the fine-tune "
        f"net ({time.perf_counter() - t1:.1f} s): loss {float(loss_g):.6f} "
        f"vs the CPU float32's {float(loss_c):.6f} (rel err {e_loss4:.3g}, "
        f"tolerance {TRAIN_LOSS_TOL}); {len(plain)} leaves by the float64 "
        f"rule, worst card/allowed {plain[0][0]:.3g} at {plain[0][1]} (card "
        f"{plain[0][2]:.3g}, CPU float32 {plain[0][3]:.3g}; allowed "
        f"max({TRAIN_GRAD_TOL}, {GRAD_NOISE_FACTOR} x CPU float32)); "
        f"{len(zero)} leaves zero up to rounding (the Conv2D biases), worst "
        + (f"card/allowed {zero[0][0]:.3g} at {zero[0][1]} (card "
           f"{zero[0][2]:.3g}, CPU float32 {zero[0][3]:.3g} of the float64 "
           f"norm; allowed {KERAS_RN50_ZERO_GRAD_FACTOR} x CPU float32)"
           if zero else "none"))
    if e_loss4 > TRAIN_LOSS_TOL or rows[0][0] > 1.0:
        raise AssertionError(f"[keras-resnet50] gradients out of bounds: "
                             f"{[r[1] for r in rows if r[0] > 1.0]}, loss "
                             f"rel err {e_loss4:.3g}")
    del g_card, g_cpu, g_64

    t1 = time.perf_counter()
    with torch.no_grad():
        ds = batches[0]
        loss64, _ = twin._loss(twin.params, twin.state,
                               (twin._tensor(ds.features.astype(np.float64)),),
                               (twin._tensor(ds.labels.astype(np.float64)),),
                               (None,), (None,))
    loss64 = float(loss64)
    cpu_s = time.perf_counter() - t1
    del twin
    zero_launches(kmods)
    fe.reset_counters()
    losses, step_ms, per_step = [], [], []
    for ds in batches:
        before = kernel_launches(kmods)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        new.fit(ds)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        after = kernel_launches(kmods)
        per_step.append((after["k1"] - before["k1"],
                         after["k2"] - before["k2"]))
        losses.append(new.score())
    fit = kernel_launches(kmods)
    decisions = dict(fe.counters())
    loss_err = abs(losses[0] - loss64) / abs(loss64)
    median = statistics.median(step_ms[1:])
    dev_ms, k1_ms, k2_ms = profile_step_split(lambda: new.fit(batches[0]))
    log(f"[keras-resnet50] fine-tune {KERAS_RN50_STEPS} Sgd({KERAS_RN50_LR})"
        f" steps of batch {KERAS_RN50_BATCH}: losses "
        + " ".join(f"{v:.6f}" for v in losses)
        + f"; the first against the CPU float64 loss {loss64:.8f}: rel err "
        f"{loss_err:.3g} (tolerance {KERAS_RN50_LOSS_TOL}; the CPU's "
        f"forward {cpu_s:.1f} s); K1/K2 a step {sorted(set(per_step))}; "
        f"decisions {decisions}; step {median:.3f} ms median of steps 2-"
        f"{KERAS_RN50_STEPS} ({KERAS_RN50_BATCH * 1e3 / median:.1f} "
        f"images/s); device {dev_ms:.3f} ms a step (K1 {k1_ms:.3f}, K2 "
        f"{k2_ms:.3f}; busy share {dev_ms / median:.3f}); "
        f"{time.perf_counter() - t0:.1f} s in the phase")
    if loss_err > KERAS_RN50_LOSS_TOL or not all(np.isfinite(losses)):
        raise AssertionError("[keras-resnet50] the card's loss disagrees "
                             "with the CPU float64 loss")
    if set(per_step) != {(KERAS_RN50_K1, KERAS_RN50_K2)} or any(
            v for k, v in fit.items() if k not in ("k1", "k2")) or \
            decisions["fused"] != fit["k1"] or any(
                v for k, v in decisions.items() if k != "fused"):
        raise AssertionError(f"[keras-resnet50] fit launches {per_step}, "
                             f"{fit}, decisions {decisions}")
    if oracles_loaded():
        raise AssertionError(f"[keras-resnet50] loaded {oracles_loaded()}")
    return {"serve_launches": serve, "fit_launches": fit,
            "latency_ms": latency, "rel_err": (e_out, e_pool),
            "step_ms": median, "device_ms": dev_ms, "k1_ms": k1_ms,
            "k2_ms": k2_ms, "busy_share": dev_ms / median,
            "loss_rel_err": loss_err, "losses": losses,
            "grad_worst": rows[0], "import_s": import_s}


# ---------------------------------------------------------------------------
# int8 serving: [int8-mm], [int8-resnet50], [int8-generate], [int8-bert]
# ---------------------------------------------------------------------------

#: NVIDIA's published dense int8 peak of one H100 SXM (operations/s)
H100_INT8_OPS_PER_S = 1979e12
INT8_BATCH = 32
#: BERT-base's dense contractions at 32 x 128 tokens, (M, K, N)
INT8_BERT_SHAPES = ((4096, 768, 768), (4096, 768, 3072), (4096, 3072, 768))
#: the generative model's decode-step contractions at 8 slots: the
#: attention projections, the two dense layers, the output layer
INT8_GEN_SHAPES = ((8, 256, 256), (8, 256, 512), (8, 512, 256))
#: the rows (examples) each card call is held against the CPU's on:
#: per-example scales make rows independent
INT8_CPU_ROWS = 2
#: raw torch._int_mm shapes whose refusals are logged as the card's rules
INT8_RULE_PROBES = ((8, 64, 64), (17, 64, 64), (24, 147, 64),
                    (24, 64, 60), (32, 64, 64))
INT8_RESNET_BUCKETS = (1, 8, 32)
INT8_GATE_IMAGES = 256
#: JAX's default gate bound (eval/quantization.py:121)
INT8_GATE_MAX_DELTA = 0.01
#: ResNet-50's card int8 output against the port's int8 CPU path
#: (norm-relative): both contract exactly, so they differ only where a
#: float32 epilogue one ulp apart (K1 against the CPU's plain BN) moves an
#: activation across a rounding midpoint of its int8 step; a flip moves one
#: input of one row by one step (1/254 of the row's range), a few in a
#: million elements, far below 1e-3 of the output's norm
INT8_CPU_REL_TOL = 1e-3
#: JAX's own bound of int8 decode against the f32 full recompute
#: (tests/test_quantized_serving.py:357-394); also the bound of BERT's
#: card int8 output against the CPU's int8 path and against f32: there
#: K3, K6 and K1 round a few values one ulp off the CPU's plain versions,
#: a quantizer turns such an ulp at a rounding midpoint into a whole int8
#: step, and over 12 layers the two int8 runs drift apart to the level of
#: the int8 noise itself (ResNet-50's K1 agrees with the CPU bit for bit,
#: and its int8 runs agree exactly)
INT8_KV_REL = 0.05
#: decode steps of the engine walk held to the recompute, per stream
INT8_WALK_STEPS = 24
#: the bench mix's runs through the int8 batcher
INT8_RUNS = 2
#: one K9 a decode step's attention layer, one K3 a prefill's, one K10 a
#: verify window's: GEN_LAYERS of each
INT8_BERT_SITES_PER_LAYER = 6
INT8_SEED = 31


def int8_rules(q) -> dict:
    """The card's rules for ``torch._int_mm``, read off the card: each
    probe shape's result ("ok" or the refusal's first line) with ``b``
    row-major and column-major. A probe that raises is the rule being
    read, not a failure; the wrapper ``q.int_mm`` must then give the plain
    contraction's int32 bit for bit at every probe."""
    gen = torch.Generator(device="cuda").manual_seed(INT8_SEED)
    rules = {}
    for m, k, n in INT8_RULE_PROBES:
        a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
        for layout, bb in (("row", b), ("col", b.t().contiguous().t())):
            try:
                torch._int_mm(a, bb)
                torch.cuda.synchronize()
                rules[(m, k, n, layout)] = "ok"
            except RuntimeError as e:
                rules[(m, k, n, layout)] = str(e).strip().splitlines()[0][:90]
        if not torch.equal(q.int_mm(a, b), q.int_mm_plain(a, b)):
            raise AssertionError(f"int_mm at {(m, k, n)} differs from the "
                                 "plain contraction")
    return rules


def resnet_conv_shapes(net, batch: int) -> dict:
    """``{(batch, H, W, C, O, kh, kw, stride, mode, padding, dilation):
    count}`` of the ConvolutionLayer vertices of ``net`` (NHWC) at
    ``batch``."""
    from deeplearning4j_tpu_torch.nn.layers.conv import ConvolutionLayer
    from deeplearning4j_tpu_torch.nn.vertices import LayerVertex
    from deeplearning4j_tpu_torch.ops.nnops import _pair
    out = {}
    for name in net._topo:
        v, ins = net._vertex_map[name]
        if not (isinstance(v, LayerVertex)
                and isinstance(v.layer, ConvolutionLayer)):
            continue
        L = v.layer
        h, w, c = net._shapes[ins[0]]
        key = (batch, h, w, c, L.n_out, *_pair(L.kernel), _pair(L.stride),
               L.mode, _pair(L.padding), _pair(L.dilation))
        out[key] = out.get(key, 0) + 1
    return out


def int8_mm_bound(m: int, k: int, n: int) -> tuple:
    """(ms, "bytes" | "operations"): int8 operands read once, the int32
    result written once, over 3.35 TB/s; 2 M N K operations over the int8
    peak."""
    t_bytes = (m * k + k * n + 4 * m * n) / 3.35e12 * 1e3
    t_ops = 2.0 * m * n * k / H100_INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_int8_conv(q, key) -> dict:
    """One ResNet-50 conv shape: the card's int32 accumulator (im2col +
    ``q.int_mm``) against the plain float64 contraction on the card bit
    for bit; the card's ``int8_conv`` on float32 input against the CPU's
    bit for bit on the first rows; times beside the float32 conv."""
    from deeplearning4j_tpu_torch.ops import nnops
    b, h, w, c, o, kh, kw, st, mode, padding, dl = key
    k_eff = ((kh - 1) * dl[0] + 1, (kw - 1) * dl[1] + 1)
    pads = nnops._spatial_pads(mode, padding, (h, w), k_eff, st)
    gen = torch.Generator(device="cuda").manual_seed(INT8_SEED + h + c + o)
    x = torch.randn((b, h, w, c), generator=gen, device="cuda")
    wf = torch.randn((o, c, kh, kw), generator=gen, device="cuda") * 0.05
    bias = torch.randn((o,), generator=gen, device="cuda")
    wq = q.quantize_per_channel(wf, 0)
    xq, _ = q.quantize_per_example(x)
    wk = wq.q.permute(2, 3, 1, 0).reshape(kh * kw * c, o)

    def contract():
        return q.int_mm(q._im2col(xq, kh, kw, st, dl, pads)[0], wk)
    acc = contract()
    cols, _ = q._im2col(xq, kh, kw, st, dl, pads)
    if not torch.equal(acc, q.int_mm_plain(cols, wk)):
        raise AssertionError(f"[int8-mm] conv {key}: the int32 accumulator "
                             "differs from the plain contraction")
    peak = int(acc.abs().max())
    kw_args = dict(stride=st, padding=padding, dilation=dl, mode=mode,
                   data_format="NHWC")
    y = q.int8_conv(x, wq, bias, **kw_args)
    y_cpu = q.int8_conv(x[:INT8_CPU_ROWS].cpu(), wq.to("cpu"), bias.cpu(),
                        **kw_args)
    if not torch.equal(y[:INT8_CPU_ROWS].cpu(), y_cpu):
        raise AssertionError(f"[int8-mm] conv {key}: the card's epilogue "
                             "differs from the CPU's")
    ms_acc = time_ms(contract, reps=15)[0]
    ms_int8 = time_ms(lambda: q.int8_conv(x, wq, bias, **kw_args),
                      reps=15)[0]
    ms_f32 = time_ms(lambda: nnops.conv2d(x, wf, bias, **kw_args),
                     reps=15)[0]
    m, kk = cols.shape
    bound, by = int8_mm_bound(m, kk, o)
    return {"m": m, "k": kk, "n": o, "acc_ms": ms_acc, "int8_conv_ms": ms_int8,
            "f32_conv_ms": ms_f32, "bound_ms": bound, "bound_by": by,
            "acc_abs_max": peak}


def check_int8_matmul(q, m: int, k: int, n: int) -> dict:
    """One dense shape: the int32 accumulator against the plain float64
    contraction bit for bit, ``int8_matmul`` against the CPU's on the
    first rows, times beside the float32 ``torch.matmul``."""
    gen = torch.Generator(device="cuda").manual_seed(INT8_SEED + m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    acc = q.int_mm(a, b)
    if not torch.equal(acc, q.int_mm_plain(a, b)):
        raise AssertionError(f"[int8-mm] ({m}, {k}, {n}): the int32 "
                             "accumulator differs from the plain one")
    x = torch.randn((m, k), generator=gen, device="cuda")
    wf = torch.randn((k, n), generator=gen, device="cuda") * 0.05
    bias = torch.randn((n,), generator=gen, device="cuda")
    wq = q.quantize_per_channel(wf, 1)
    y = q.int8_matmul(x, wq.q, wq.scale, bias)
    rows = min(m, 256)
    y_cpu = q.int8_matmul(x[:rows].cpu(), wq.q.cpu(), wq.scale.cpu(),
                          bias.cpu())
    if not torch.equal(y[:rows].cpu(), y_cpu):
        raise AssertionError(f"[int8-mm] ({m}, {k}, {n}): the card's "
                             "epilogue differs from the CPU's")
    ms_acc = time_ms(lambda: q.int_mm(a, b), reps=15)[0]
    ms_int8 = time_ms(lambda: q.int8_matmul(x, wq.q, wq.scale, bias),
                      reps=15)[0]
    ms_f32 = time_ms(lambda: torch.matmul(x, wf), reps=15)[0]
    bound, by = int8_mm_bound(m, k, n)
    return {"m": m, "k": k, "n": n, "acc_ms": ms_acc,
            "int8_matmul_ms": ms_int8, "f32_matmul_ms": ms_f32,
            "bound_ms": bound, "bound_by": by,
            "acc_abs_max": int(acc.abs().max())}


def phase_int8_mm(env, models) -> dict:
    """[int8-mm]: the int8 contraction at every ResNet-50 conv shape at
    batch 32, BERT-base's dense shapes and the generative decode rows."""
    from deeplearning4j_tpu_torch.ops import quantize as q
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    rules = int8_rules(q)
    log("[int8-mm] torch._int_mm on the card, raw (M, K, N, b layout): "
        + "; ".join(f"{s}: {r}" for s, r in rules.items()))
    q.reset_counters()
    net = models.resnet50(seed=0)
    net.init(device="cpu")  # the shapes only
    shapes = resnet_conv_shapes(net, INT8_BATCH)
    del net
    rows = {}
    with env.precision("cuda"):
        for key, count in shapes.items():
            r = check_int8_conv(q, key)
            r["count"] = count
            rows[f"conv{key[1:]}"] = r
        for m, k, n in INT8_BERT_SHAPES + INT8_GEN_SHAPES:
            rows[f"mm{(m, k, n)}"] = check_int8_matmul(q, m, k, n)
    for tag, r in rows.items():
        log(f"[int8-mm] {tag}: M {r['m']} K {r['k']} N {r['n']}: int32 "
            f"accumulator bit for bit with the plain float64 one (|acc| up to"
            f" {r['acc_abs_max']}), the epilogue the CPU's bit for bit; "
            f"contraction {r['acc_ms']:.4f} ms (bound {r['bound_ms']:.4f}, "
            f"{r['bound_by']}), int8 call "
            f"{r.get('int8_conv_ms', r.get('int8_matmul_ms')):.4f} ms, "
            f"float32 {r.get('f32_conv_ms', r.get('f32_matmul_ms')):.4f} ms")
    big = max((r["acc_abs_max"] for r in rows.values()), default=0)
    log(f"[int8-mm] {len(shapes)} distinct ResNet-50 conv shapes, "
        f"{len(INT8_BERT_SHAPES)} BERT-base and {len(INT8_GEN_SHAPES)} decode"
        f" shapes; largest |acc| {big} (2^24 = {2 ** 24}); padded calls "
        f"{q.pad_counters()}; {smi_line()}; {time.perf_counter() - t0:.1f} s")
    return {"rows": rows, "rules": {str(k): v for k, v in rules.items()},
            "pads": q.pad_counters()}


def cpu_graph(net):
    """``net``'s weights and state in a ComputationGraph on the CPU."""
    from deeplearning4j_tpu_torch.nn import graph
    cpu = graph.ComputationGraph(net.conf).init(device="cpu")
    cpu.params = {v: {k: t.cpu() for k, t in p.items()}
                  for v, p in net.params.items()}
    cpu.state = {v: {k: t.cpu() for k, t in p.items()}
                 for v, p in net.state.items()}
    return cpu


def phase_int8_resnet50(kmods, fe, env, models) -> dict:
    """[int8-resnet50]: zoo ResNet-50, uncut, through
    ``InferenceEngine(quantize="int8")``."""
    from deeplearning4j_tpu_torch.eval.quantization import quantization_gate
    from deeplearning4j_tpu_torch.ops import quantize as q
    from deeplearning4j_tpu_torch.serving.engine import InferenceEngine
    from deeplearning4j_tpu_torch.tools.profile_serving import device_us
    from deeplearning4j_tpu_torch.utils.tree import leaves
    env.Environment.instance().f32_matmul_precision = "highest"
    net = models.resnet50(seed=0).init(device="cuda")
    f32_bytes = sum(t.numel() * t.element_size() for t in leaves(net.params))
    eng = InferenceEngine(net, quantize="int8")
    t0 = time.perf_counter()
    eng.warmup(INT8_RESNET_BUCKETS)
    warm_s = time.perf_counter() - t0
    total, qbytes = q.quantized_bytes(eng._serving_params())
    rep = eng._q_report
    k1_per_forward = len(k1_path_calls(net, 1))
    convs = sum(resnet_conv_shapes(net, 1).values())
    log(f"[int8-resnet50] zoo ResNet-50 on cuda: {net.num_params()} params; "
        f"InferenceEngine(quantize='int8') warmed at "
        f"{list(INT8_RESNET_BUCKETS)} in {warm_s:.1f} s: {rep.sites} weights "
        f"quantized; weight bytes f32 {f32_bytes}, int8 tree {total} "
        f"({qbytes} int8 values, {total - qbytes} scales and the rest)")
    rng = np.random.default_rng(INT8_SEED)
    x = rng.standard_normal((INT8_BATCH, 224, 224, 3), dtype=np.float32)

    # ---- the int8 serving path: counts from 0, read after ----
    zero_launches(kmods)
    fe.reset_counters()
    q.reset_counters()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = eng.output(x)
        walls.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        eng.output(x)
    forwards = 6
    torch.cuda.synchronize()
    launches = kernel_launches(kmods)
    dev = sum(device_us(e) for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    want = {k: 0 for k in launches}
    want["k1"] = forwards * k1_per_forward
    decisions = q.counters()
    if launches != want or fe.counters()["fused"] != want["k1"] \
            or sum(fe.counters().values()) != want["k1"] \
            or decisions != {"conv": forwards * convs, "dot": forwards} \
            or eng.q_fallbacks or eng.stats()["cold_calls"]:
        raise AssertionError(
            f"[int8-resnet50] launches {launches} (want {want}), epilogue "
            f"decisions {fe.counters()}, quantize decisions {decisions}, "
            f"fallbacks {eng.q_fallbacks}, stats {eng.stats()}")
    if y.shape != (INT8_BATCH, 1000) or not np.isfinite(y).all() or \
            not np.allclose(y.sum(axis=1), 1.0, atol=1e-4):
        raise AssertionError(f"[int8-resnet50] bad output {y.shape}")
    wall = statistics.median(walls)
    log(f"[int8-resnet50] batch-{INT8_BATCH} request: wall {wall:.3f} ms "
        f"(median of 5), {INT8_BATCH * 1e3 / wall:.1f} images/s; device "
        f"{dev:.3f} ms (busy share {dev / wall:.3f}); {k1_per_forward} K1 a "
        f"forward (the JAX package's epilogue count for the quantized conf, "
        f"tests/test_torch_quantize.py), quantize decisions {decisions}, "
        f"no fallback, padded calls {q.pad_counters()}")
    # the card against the port's int8 CPU path, same weights
    t0 = time.perf_counter()
    cpu = cpu_graph(net)
    y_cpu = InferenceEngine(cpu, device="cpu", quantize="int8").output(
        x[:INT8_CPU_ROWS])
    rel = rel_err(y[:INT8_CPU_ROWS], y_cpu)
    del cpu
    log(f"[int8-resnet50] card vs the port's int8 CPU path, batch "
        f"{INT8_CPU_ROWS}: rel err {rel:.3g} (tolerance {INT8_CPU_REL_TOL}; "
        f"CPU {time.perf_counter() - t0:.1f} s)")
    if not rel <= INT8_CPU_REL_TOL:
        raise AssertionError("[int8-resnet50] the card's int8 output "
                             "disagrees with the CPU's int8 path")
    f32_eng = InferenceEngine(net).warmup([INT8_BATCH])
    f32_rep = f32_eng.memory_report(INT8_BATCH)
    q_rep = eng.memory_report(INT8_BATCH)
    # f32 and int8 requests in turns (f32, int8, int8, f32; 5 each)
    turns = {"f32": [], "int8": []}
    for tag in ("f32", "int8", "int8", "f32"):
        e = f32_eng if tag == "f32" else eng
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e.output(x)
            turns[tag].append((time.perf_counter() - t0) * 1e3)
    turns = {k: statistics.median(v) for k, v in turns.items()}
    log(f"[int8-resnet50] batch-{INT8_BATCH} request in turns (median of "
        f"10): f32 {turns['f32']:.3f} ms, int8 {turns['int8']:.3f} ms")
    # the gate: int8 against f32, top-1 agreement on 256 seeded images
    t0 = time.perf_counter()
    grng = np.random.default_rng(INT8_SEED + 1)
    batches = [grng.standard_normal((INT8_BATCH, 224, 224, 3),
                                    dtype=np.float32)
               for _ in range(INT8_GATE_IMAGES // INT8_BATCH)]
    # gated: the card met JAX's default bound on random weights
    res = quantization_gate(net, batches, max_delta=INT8_GATE_MAX_DELTA)
    log(f"[int8-resnet50] quantization_gate (int8 vs f32 engine, label-free "
        f"top-1 disagreement) on {res.examples} seeded images: delta "
        f"{res.delta:.4f} against JAX's default max_delta "
        f"{INT8_GATE_MAX_DELTA}: met ({time.perf_counter() - t0:.1f} s); "
        f"memory at batch "
        f"{INT8_BATCH}: params f32 {f32_rep['params_bytes']} vs int8 "
        f"{q_rep['params_bytes']} ({q_rep['quantized_weight_bytes']} int8), "
        f"peak {f32_rep['peak_bytes']} vs {q_rep['peak_bytes']}")
    return {"launches": launches, "forwards": forwards,
            "k1_per_forward": k1_per_forward, "wall_ms": wall,
            "device_ms": dev, "busy_share": dev / wall, "rel_err": rel,
            "turns_ms": turns,
            "gate_delta": res.delta, "gate_passed": res.passed,
            "weight_bytes_f32": f32_bytes, "weight_bytes_int8": total,
            "int8_value_bytes": qbytes, "sites": rep.sites,
            "peak_bytes": {"f32": f32_rep["peak_bytes"],
                           "int8": q_rep["peak_bytes"]},
            "pads": q.pad_counters()}


def int8_walk(net, cpu, prompts, steps: int) -> dict:
    """The bench's prompts through ``GenerativeEngine(quantize="int8",
    kv_cache="int8")`` on the card, greedy, one prompt a slot, and the
    same tokens through the same engine on the CPU (teacher-forced): each
    step's card logits against the f32 full-prefix recompute on the card
    (``INT8_KV_REL``), and the card's token the CPU's argmax wherever the
    CPU's top-2 margin exceeds that bound."""
    from deeplearning4j_tpu_torch.serving.engine import GenerativeEngine
    from deeplearning4j_tpu_torch.tools import profile_generate as pg
    S, V = len(prompts), pg.VOCAB
    cache = next_pow2(max(len(p) for p in prompts) + steps + 1)
    pb = [next_pow2(max(len(p) for p in prompts))]
    engs = [GenerativeEngine(m, slots=S, quantize="int8", kv_cache="int8",
                             device=d).warmup([cache], pb)
            for m, d in ((net, "cuda"), (cpu, "cpu"))]
    states = [e.new_state(cache) for e in engs]
    eye = np.eye(V, dtype=np.float32)
    logits = [np.zeros((steps + 1, S, V), np.float32) for _ in engs]
    for i, p in enumerate(prompts):
        for j, e in enumerate(engs):
            states[j], lg = e.prefill(states[j], p, len(p), i)
            logits[j][0, i] = lg
    toks = [logits[0][0].argmax(-1)]
    for t in range(1, steps + 1):
        x_t = eye[toks[-1]][:, None, :]
        for j, e in enumerate(engs):
            states[j], lg = e.decode(states[j], x_t, np.ones(S, np.int32))
            logits[j][t] = lg
        toks.append(logits[0][t].argmax(-1))
    # the f32 full-prefix recompute on the card, greedy stream teacher-fed
    T = max(len(p) for p in prompts) + steps
    seq = np.zeros((S, T, V), np.float32)
    plens = np.array([len(p) for p in prompts])
    for i, p in enumerate(prompts):
        seq[i, :len(p)] = p
        for t in range(steps):
            seq[i, len(p) + t] = eye[toks[t][i]]
    with torch.inference_mode():
        full = net._full_context(
            net.params, torch.from_numpy(seq).cuda(), net.state,
            torch.from_numpy(plens).cuda(),
            torch.from_numpy(plens + steps).cuda()).float().cpu().numpy()
    worst_rec, worst_cpu, checked, mism = 0.0, 0.0, 0, 0
    for t in range(steps + 1):
        for i in range(S):
            ref = full[i, plens[i] - 1 + t]
            worst_rec = max(worst_rec, float(
                np.abs(logits[0][t, i] - ref).max() / np.abs(ref).max()))
            c = logits[1][t, i]
            worst_cpu = max(worst_cpu, float(
                np.abs(logits[0][t, i] - c).max() / np.abs(c).max()))
            top2 = np.sort(c)[-2:]
            if (top2[1] - top2[0]) / abs(top2[1]) > INT8_KV_REL:
                checked += 1
                mism += int(toks[t][i] != c.argmax())
    return {"rel_err_vs_recompute": worst_rec, "rel_err_vs_cpu": worst_cpu,
            "margin_steps": checked,
            "token_mismatches": mism, "steps": steps, "streams": S,
            "cache_bytes_int8": engs[0].cache_bytes(cache),
            "cache_len": cache}


def next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def phase_int8_generate(counters, gen) -> dict:
    """[int8-generate]: the bench's generative model through
    ``ContinuousBatcher(quantize="int8", kv_cache="int8")``."""
    from deeplearning4j_tpu_torch.ops import quantize as q
    from deeplearning4j_tpu_torch.serving.batcher import ContinuousBatcher
    from deeplearning4j_tpu_torch.serving.disagg import PrefillReplica
    from deeplearning4j_tpu_torch.serving.engine import (
        GenerativeEngine, PagedGenerativeEngine)
    from deeplearning4j_tpu_torch.tools import profile_generate as pg
    net, cpu = gen["net"], gen["cpu"]
    int8 = dict(quantize="int8", kv_cache="int8")
    rows = {}
    q.reset_counters()
    # the bench mix (contiguous): K3 a prefill, K9 a step
    t0 = time.perf_counter()
    cb = ContinuousBatcher(net, **pg.BENCH, **int8)
    log(f"[int8-generate] ContinuousBatcher({pg.BENCH}, quantize='int8', "
        f"kv_cache='int8') built and warmed in {time.perf_counter() - t0:.1f}"
        f" s")
    mix = pg.prompts(*pg.BENCH_PROMPTS)
    try:
        row = generate_path(cb, mix, INT8_RUNS, counters)
        est = cb.engine.stats()
        cache_q = cb.engine.cache_bytes(pg.BENCH["max_cache_len"])
    finally:
        cb.shutdown()
    cache_f = GenerativeEngine(net, slots=pg.BENCH["slots"]).cache_bytes(
        pg.BENCH["max_cache_len"])
    if est["quantize_fallbacks"] or est["quantize"] != "int8" \
            or est["kv_cache"] != "int8" or not cache_q * 2 < cache_f:
        raise AssertionError(f"[int8-generate] engine stats {est}, cache "
                             f"bytes {cache_q} vs f32 {cache_f}")
    f32 = gen["rows"]["bench"]
    log(f"[int8-generate] bench mix, {INT8_RUNS} runs + 1 profiled: "
        f"{row['tokens_per_s']:.1f} tokens/s (f32 {f32['tokens_per_s']:.1f}),"
        f" TTFT p50 {row['ttft_ms_p50']:.3f} ms (f32 "
        f"{f32['ttft_ms_p50']:.3f}), TPOT p50 {row['tpot_ms_p50']:.3f} ms "
        f"(f32 {f32['tpot_ms_p50']:.3f}); launches {row['launches']} for "
        f"{row['prefills']} prefills and {row['decode_steps']} decode steps;"
        f" device {row['device_ms']} ms (busy share "
        f"{row['device_busy_share']}); cache bytes {cache_q} vs f32 "
        f"{cache_f}")
    row.pop("streams")
    row.pop("last_logits")
    rows["bench"] = row
    # each step's logits against the f32 recompute, tokens against the CPU
    t0 = time.perf_counter()
    walk = int8_walk(net, cpu, mix, INT8_WALK_STEPS)
    log(f"[int8-generate] engine walk, {walk['streams']} streams x "
        f"{walk['steps']} steps: max|int8 - f32 recompute|/max|f32| "
        f"{walk['rel_err_vs_recompute']:.4g}, against the CPU's int8 path "
        f"{walk['rel_err_vs_cpu']:.4g} (bound {INT8_KV_REL} each); "
        f"{walk['margin_steps']} steps with a CPU top-2 margin above the "
        f"bound, {walk['token_mismatches']} card tokens off the CPU int8 "
        f"path's argmax there ({time.perf_counter() - t0:.1f} s)")
    if not walk["rel_err_vs_recompute"] <= INT8_KV_REL \
            or not walk["rel_err_vs_cpu"] <= INT8_KV_REL \
            or walk["token_mismatches"]:
        raise AssertionError("[int8-generate] int8 decode outside JAX's bound"
                             " or off the CPU's tokens")
    # the paged prefix mix with speculation: K10 a verify window
    sysmix = pg.system_prompt_mix()
    kw = dict(pg.PAGED, draft_model=net, speculate_k=pg.SPECULATE_K, **int8)
    cb = ContinuousBatcher(net, **kw)
    try:
        srow = spec_path(cb, sysmix, INT8_RUNS, counters)
        pool_q = cb.engine.pool_bytes()
    finally:
        cb.shutdown()
    pool_f = PagedGenerativeEngine(
        net, slots=pg.PAGED["slots"], pages=cb.engine.pages,
        page_size=pg.PAGED["page_size"],
        max_cache_len=pg.PAGED["max_cache_len"]).pool_bytes()
    srow["check"] = {
        "last_rel_err_vs_f32": max(pg.teacher_forced(
            cpu, sysmix[i], srow["streams"][i],
            srow["last_logits"][i])["last_rel_err"]
            for i in range(len(sysmix)))}
    if not srow["verify_steps"] or not pool_q * 2 < pool_f \
            or not srow["check"]["last_rel_err_vs_f32"] <= INT8_KV_REL:
        raise AssertionError(f"[int8-generate] speculative paged mix: "
                             f"{srow['verify_steps']} verify steps, pool "
                             f"{pool_q} vs {pool_f}, {srow['check']}")
    log(f"[int8-generate] paged prefix mix with speculation (k "
        f"{pg.SPECULATE_K}): {srow['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{srow['ttft_ms_p50']:.3f} ms, TPOT p50 {srow['tpot_ms_p50']:.3f} "
        f"ms; launches {srow['launches']} for {srow['verify_steps']} verify "
        f"steps, {srow['decode_steps']} + {srow['draft_steps']} decode steps"
        f", {srow['prefills']} + {srow['draft_prefills']} prefills; last "
        f"step vs the f32 recompute {srow['check']['last_rel_err_vs_f32']:.4g}"
        f"; pool bytes {pool_q} vs f32 {pool_f}")
    srow.pop("streams")
    srow.pop("last_logits")
    rows["spec"] = srow
    # one int8 shipment: exported, through the socket, imported bit for bit
    P = pg.PAGED["page_size"]
    prompt = sysmix[0]
    n_pages = -(-len(prompt) // P)
    pre = PrefillReplica(net, pages=2 * n_pages + 1, page_size=P,
                         max_cache_len=pg.PAGED["max_cache_len"],
                         prompt_buckets=[len(prompt)], **int8)
    ship = pre.prefill(prompt)
    back, nbytes, wire = ship_over_socket(ship)
    dst = PagedGenerativeEngine(net, slots=1, pages=2 * n_pages + 1,
                                page_size=P,
                                max_cache_len=pg.PAGED["max_cache_len"],
                                **int8).warmup(
        [pg.PAGED["max_cache_len"]], [next_pow2(len(prompt))],
        migrate_buckets=[n_pages])
    st = dst.new_state(pg.PAGED["max_cache_len"])
    pages = dst.pool.alloc(n_pages)
    dst.import_pages(st, pages, back.payload)
    again = dst.export_pages(st, pages)
    same = back.kv_quant and set(again) == set(ship.payload) and all(
        set(again[l]) == {"k", "v", "k_scale", "v_scale"}
        and all(torch.equal(again[l][n], t) for n, t in lv.items())
        for l, lv in ship.payload.items())
    if not same:
        raise AssertionError("[int8-generate] the int8 shipment did not "
                             "import bit for bit")
    log(f"[int8-generate] one int8 KVShipment ({n_pages} pages, {nbytes} "
        f"bytes, int8 values and f32 scale leaves) through a socketpair in "
        f"{wire * 1e3:.3f} ms and imported into a fresh int8 pool bit for "
        f"bit")
    return {"rows": rows, "walk": walk, "cache_bytes": (cache_q, cache_f),
            "pool_bytes": (pool_q, pool_f), "shipment_bytes": nbytes,
            "launches": {"bench": row["launches"],
                         "spec": srow["launches"]},
            "pads": q.pad_counters()}


def phase_int8_bert(kmods, fa, fe, env) -> dict:
    """[int8-bert]: BERT-base, ``"fusable"`` spelling, after
    ``fuse_epilogues``, then ``quantize_weights``."""
    from deeplearning4j_tpu_torch.autodiff.quantize import quantize_weights
    from deeplearning4j_tpu_torch.models.bert import OUTPUT
    from deeplearning4j_tpu_torch.ops import quantize as q
    from deeplearning4j_tpu_torch.tools.profile_bert import (
        build, launch_counts, profile, request)
    from deeplearning4j_tpu_torch.utils.convert import samediff_from_numpy
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    sd, reports = build("fusable", seed=0, seq_len=BERT_SEQ)
    feeds = request(np.random.default_rng(INT8_SEED), INT8_BATCH, BERT_SEQ)
    parity = request(np.random.default_rng(INT8_SEED + 1), INT8_CPU_ROWS,
                     BERT_SEQ)
    y_f32 = sd.output(feeds, [OUTPUT])[OUTPUT]
    y_f32_parity = sd.output(parity, [OUTPUT])[OUTPUT]
    f32_row = profile(sd, feeds, walls=5)
    mm_sites = [r.output for r in sd._ops if r.op == "linalg.mmul"
                and sd._vars[r.inputs[1]].kind in ("VARIABLE", "CONSTANT")]
    shapes_f32 = {n: v.shape for n, v in sd.output(parity, mm_sites).items()}
    q.reset_counters()
    rep = quantize_weights(sd)
    want_sites = INT8_BERT_SITES_PER_LAYER * BERT_LAYERS
    shapes_q = {n: v.shape for n, v in sd.output(parity, mm_sites).items()}
    log(f"[int8-bert] bert_base(spelling='fusable') fused "
        f"({reports['epilogues']}), then {rep}: sites {rep.matched} (JAX's "
        f"pass on the tiny graph: {INT8_BERT_SITES_PER_LAYER} a layer, "
        f"tests/test_torch_quantize_samediff.py), skipped {rep.skipped}, "
        f"rewrite counters {q.rewrite_counters()}; "
        f"{time.perf_counter() - t0:.1f} s")
    if (rep.matched, rep.skipped) != (want_sites, 0) \
            or sorted(rep.sites) != sorted(mm_sites) \
            or shapes_q != shapes_f32:
        raise AssertionError(f"[int8-bert] rewrite {rep} {rep.reasons}, "
                             "or a site changed shape")
    per_forward = {"k6": LN_SITES, "k1": BERT_LAYERS, "k3": BERT_LAYERS}
    sd.output(feeds, [OUTPUT])  # warm-up of the int8 path
    # ---- the int8 BERT serving path: counts from 0, read after ----
    zero_launches(kmods)
    fa.reset_counters()
    fe.reset_counters()
    q.reset_counters()
    for _ in range(3):
        before = launch_counts()
        y_q = sd.output(feeds, [OUTPUT])[OUTPUT]
        got = {k: v - before[k] for k, v in launch_counts().items()
               if v - before[k]}
        if got != per_forward:
            raise AssertionError(f"[int8-bert] launches {got}, expected "
                                 f"{per_forward}")
    row = profile(sd, feeds, walls=5)
    got_cpu = sd.output(parity, [OUTPUT])[OUTPUT]
    forwards = 3 + 5 + 1 + 3 + 1
    launches = kernel_launches(kmods)
    want = {k: forwards * per_forward.get(k, 0) for k in launches}
    decisions = q.counters()
    if launches != want or not only_fused(fa, fe) \
            or decisions != {"dot": forwards * want_sites}:
        raise AssertionError(f"[int8-bert] launches {launches} (want {want})"
                             f", decisions {decisions}, "
                             f"{fa.counters()} {fe.counters()}")
    t0 = time.perf_counter()
    values = {n: sd.get_value(n) for n in sd._values}
    cpu = samediff_from_numpy(sd.to_json(), values, "cpu")
    want_cpu = cpu.output(parity, [OUTPUT])[OUTPUT]
    del cpu
    rel_cpu = rel_err(got_cpu, want_cpu)
    rel_f32 = rel_err(y_q, y_f32)
    rel_cpu_f32 = rel_err(want_cpu, y_f32_parity)
    log(f"[int8-bert] batch {INT8_BATCH} x {BERT_SEQ}: wall "
        f"{row['wall_ms_median']:.3f} ms (f32 {f32_row['wall_ms_median']:.3f}"
        f"), device {row['device_ms']:.3f} ms (f32 {f32_row['device_ms']:.3f},"
        f" busy share {row['device_busy_share']:.3f}); per forward "
        f"{per_forward}, quantize decisions {decisions}; int8 vs f32 rel err"
        f" {rel_f32:.4g}; card vs the port's int8 CPU path at batch "
        f"{INT8_CPU_ROWS} rel err {rel_cpu:.3g}, the CPU's int8 path vs f32 "
        f"{rel_cpu_f32:.4g} (tolerance {INT8_KV_REL} each; CPU "
        f"{time.perf_counter() - t0:.1f} s); weight bytes {rep.bytes_f32} ->"
        f" {rep.bytes_q} ({rep.bytes_saved} saved)")
    if not (rel_cpu <= INT8_KV_REL and rel_f32 <= INT8_KV_REL
            and rel_cpu_f32 <= INT8_KV_REL):
        raise AssertionError("[int8-bert] the card's int8 output lies "
                             "outside the int8 bound of the CPU's int8 path "
                             "or of f32")
    return {"launches": launches, "forwards": forwards, "row": row,
            "f32_row": f32_row, "rel_err_vs_cpu": rel_cpu,
            "rel_err_vs_f32": rel_f32, "cpu_rel_err_vs_f32": rel_cpu_f32,
            "sites": rep.matched,
            "bytes": (rep.bytes_f32, rep.bytes_q)}


# data-parallel training: [dp-resnet50], [dp-zero1], [dp-tp], [dp-checkpoint]
#: zoo ResNet-50 (seed 0, Adam(1e-3)), global batch 32, 3 steps; 4 batches
#: (the checkpoint run's 4 steps) of seeded images; a ragged batch of 31
DP_BATCH, DP_STEPS, DP_CKPT_STEPS, DP_RAGGED = 32, 3, 4, 31
DP_SAVE_AT = 2
#: the Adam gate: the change of the params (and of the BN running
#: statistics) from the initial state against the float64 CPU run's,
#: rel_err within max(DP_GATE_FLOOR, DP_GATE_FACTOR x the single-process
#: card fit's own). Adam's float32 change reads about 0.49 of float64's
#: (ill-conditioned small gradients take full steps), and every sound path
#: read 0.99-1.06 x the single fit, so a state left unchanged (1.0) fails
DP_GATE_FLOOR, DP_GATE_FACTOR = 1e-3, 1.25
#: the SGD gate: one SGD step (learning rate DP_SGD_LR) of each path against
#: the single-process card step on the same rows, rel_err of the params'
#: change within DP_SGD_GATE. Summing a ResNet-50 step's float32 terms in
#: another order moves it 2-3% (the gate's control: the single-process
#: step on its rows permuted, re-measured in every run, which must read
#: under the gate); SGD's step is linear in the gradient, so a fault of
#: its scale (a loss over the rank's own label count: twice the step) or of
#: its BatchNorm moments (each rank's own rows: the mean of the two halves'
#: single-process steps) reads near 1, and the phase checks that both
#: faults, computed so, fail the gate
DP_SGD_LR, DP_SGD_GATE = 1.0, 0.1
#: torch threads of the float64 CPU reference process, which starts right
#: after the build and runs beside the earlier phases on one core
DP_REF_THREADS = 1
DP_TIMEOUT = 600.0
#: the runs compared bit for bit (ZeRO-1 against replicated, a restored
#: state's continuation against the ZIP's) use cuDNN's deterministic
#: algorithms: its default convolution backward adds with atomics, and
#: [train]'s fit does not repeat bit for bit without them
DP_DETERMINISTIC_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


def dp_data(root):
    """The batches, and the same batches reordered so that a one-process
    ``accum_steps=2`` step splits each into the microbatches the 2-rank
    run's (each rank's half in two) make: microbatch i holds rows
    [8i, 8i + 8) of both ranks' halves."""
    rng = np.random.default_rng(11)
    n = DP_BATCH * DP_CKPT_STEPS
    x = rng.standard_normal((n, 224, 224, 3), dtype=np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, n)]
    h, q = DP_BATCH // 2, DP_BATCH // 4
    order = np.concatenate([np.r_[0:q, h:h + q, q:h, h + q:DP_BATCH] + i
                            for i in range(0, n, DP_BATCH)])
    path = os.path.join(root, "dp_data.npz")
    np.savez(path, x=x, y=y, x_acc=x[order], y_acc=y[order])
    return path, x, y


def dp_check_steps(rec, where, per_step=(LAUNCHES_PER_FORWARD,) * 2):
    """Every call of a scenario launched ``per_step`` (K1, K2) with only
    fused decisions."""
    for i, (got, dec) in enumerate(zip(rec["launches"], rec["decisions"])):
        if tuple(got) != tuple(per_step) or dec["fused"] != got[0] or \
                dec["fallback_act"] or dec["fallback_platform"]:
            raise AssertionError(f"[{where}] step {i + 1}: {got} K1/K2 "
                                 f"launches, decisions {dec} (expected "
                                 f"{per_step}, fused only)")


def dp_errors(got, ref, init) -> dict:
    """rel_err of the change from ``init`` of the params and of the BN
    state against the float64 run's."""
    return {k: rel_err(np.asarray(got[k], np.float64) - init[k],
                       np.asarray(ref[k], np.float64) - init[k])
            for k in ("params", "state")}


def dp_row(rec) -> dict:
    c = rec.get("counters", {})
    n = max(1, len(rec["step_ms"]))
    by = c.get("bytes", {})
    return {"step_ms": rec["step_ms"],
            "step_ms_median": statistics.median(rec["step_ms"]),
            "collective_ms_per_step": 1e3 * c.get("collective_s", 0) / n,
            "bytes_reduced_per_step": (by.get("all_reduce", 0)
                                       + by.get("reduce_scatter", 0)) / n,
            "calls": c.get("calls"), "backend": c.get("backend"),
            "fit_calls": rec.get("fit_calls")}


def dp_reference_start(models) -> dict:
    """Start the float64 CPU reference of the data-parallel phases (the
    same steps from the same initial weights, one process on
    ``DP_REF_THREADS`` cores) beside the phases before them: its inputs
    are the seeded batches, written here."""
    import tempfile

    from deeplearning4j_tpu_torch.parallel import multihost_sim as sim
    root = tempfile.mkdtemp(prefix="dl4j_dp_")
    data, x, y = dp_data(root)
    b, steps = DP_BATCH, list(range(DP_STEPS))
    run = sim.run_scenarios(
        {"data": data, "model": {"zoo": "resnet50", "seed": 0,
                                 "dtype": "DOUBLE"},
         "scenarios": [
             {"name": "ref", "batch": b, "steps": steps},
             {"name": "ref_ragged", "batch": DP_RAGGED, "rows": DP_RAGGED,
              "steps": [0]},
             {"name": "ref_acc2", "batch": b, "steps": steps, "x": "x_acc",
              "y": "y_acc", "wrapper": {"accum_steps": 2}}]},
        os.path.join(root, "ref"), 1, timeout=DP_TIMEOUT + 900,
        threads=DP_REF_THREADS, wait=False, tag="ref")
    return {"root": root, "data": data, "x": x, "y": y, "run": run,
            "t0": time.perf_counter()}


def phase_dp(kmods, fe, env, models, dp_ref) -> dict:
    import shutil

    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    from deeplearning4j_tpu_torch.parallel import multihost_sim as sim
    from deeplearning4j_tpu_torch.parallel.checkpoint import \
        TrainingCheckpointer
    from deeplearning4j_tpu_torch.parallel.data_parallel import \
        ParallelWrapper
    from deeplearning4j_tpu_torch.serving.engine import InferenceEngine
    from deeplearning4j_tpu_torch.utils.serializer import load_model
    k1 = kmods["k1"]
    env.Environment.instance().f32_matmul_precision = "highest"
    t0 = time.perf_counter()
    clock = {}

    def mark(name):
        clock[name] = round(time.perf_counter() - t0, 1)
    root, data, x, y = (dp_ref[k] for k in ("root", "data", "x", "y"))
    ref = dp_ref["run"]
    two = one = None
    try:
        ck, zip2 = os.path.join(root, "ckpt"), os.path.join(root, "s2.zip")
        zoo = {"zoo": "resnet50", "seed": 0}
        zoo_sgd = {**zoo, "kwargs": {"updater": Sgd(
            learning_rate=DP_SGD_LR).to_dict()}}
        b = DP_BATCH
        steps = list(range(DP_STEPS))
        torch.cuda.empty_cache()
        two = sim.run_scenarios(
            {"data": data, "model": zoo, "precision": "highest",
             "deterministic": True, "scenarios": [
                 {"name": "ckpt", "batch": b,
                  "steps": list(range(DP_CKPT_STEPS)),
                  "wrapper": {"shard_update": True, "overlap_grads": True},
                  "checkpoint": {"dir": ck, "async": True,
                                 "save_at": [DP_SAVE_AT, DP_CKPT_STEPS],
                                 "zip_at": DP_SAVE_AT, "zip": zip2}},
                 {"name": "dp2", "batch": b, "steps": steps,
                  "wrapper": {"time_collectives": True}},
                 {"name": "dp2_ragged", "batch": DP_RAGGED,
                  "rows": DP_RAGGED, "steps": [0], "wrapper": {}},
                 {"name": "zero1", "batch": b, "steps": steps,
                  "wrapper": {"shard_update": True,
                              "overlap_grads": True}},
                 {"name": "zero1_acc2", "batch": b, "steps": steps,
                  "wrapper": {"shard_update": True, "overlap_grads": True,
                              "accum_steps": 2}},
                 {"name": "tp", "batch": b, "steps": steps,
                  "wrapper": {"mesh": [1, 2], "model_axis": "model"}},
                 {"name": "sgd_dp2", "model": zoo_sgd, "batch": b,
                  "steps": [0], "wrapper": {}},
                 {"name": "sgd_ragged", "model": zoo_sgd,
                  "batch": DP_RAGGED, "rows": DP_RAGGED, "steps": [0],
                  "wrapper": {}},
                 {"name": "sgd_zero1_acc2", "model": zoo_sgd, "batch": b,
                  "steps": [0], "wrapper": {"shard_update": True,
                                            "overlap_grads": True,
                                            "accum_steps": 2}},
                 {"name": "sgd_tp", "model": zoo_sgd, "batch": b,
                  "steps": [0], "wrapper": {"mesh": [1, 2],
                                            "model_axis": "model"}}]},
            os.path.join(root, "two"), 2, timeout=DP_TIMEOUT,
            device="cuda", backend="gloo", wait=False, tag="two",
            extra_env=DP_DETERMINISTIC_ENV)
        one = sim.run_scenarios(
            {"data": data, "model": zoo, "precision": "highest",
             "scenarios": [{"name": "dp1", "batch": b, "steps": steps,
                            "wrapper": {"time_collectives": True}},
                           {"name": "sgd_dp1", "model": zoo_sgd,
                            "batch": b, "steps": [0], "wrapper": {}}]},
            os.path.join(root, "one"), 1, timeout=DP_TIMEOUT,
            device="cuda", backend="nccl", wait=False, tag="one")

        # the single-process card fits (no wrapper): the gates' scale
        def single(rows, n_steps):
            net = models.resnet50(seed=0).init(device="cuda")
            rec = {"launches": [], "decisions": []}
            for i in range(n_steps):
                k1.launches = k1.bwd_launches = 0
                fe.reset_counters()
                net.fit(DataSet(x[i * b:i * b + rows], y[i * b:i * b + rows]))
                torch.cuda.synchronize()
                rec["launches"].append([k1.launches, k1.bwd_launches])
                rec["decisions"].append(fe.counters())
            dp_check_steps(rec, "dp-resnet50 single")
            out = {"params": sim._flat(net.params),
                   "state": sim._flat(net.state)}
            del net
            return out, rec
        single_fit, single_rec = single(b, DP_STEPS)
        single_rag, rag_rec = single(DP_RAGGED, 1)

        # one SGD step of the same rows in this process: the SGD gate's
        # truth, and the halves the BatchNorm fault is computed from
        def sgd_step(lo, hi, xs=x, ys=y, accum=1):
            net = models.resnet50(seed=0, updater=Sgd(
                learning_rate=DP_SGD_LR)).init(device="cuda")
            fit = ParallelWrapper(net, accum_steps=accum).fit \
                if accum > 1 else net.fit
            fit(DataSet(xs[lo:hi], ys[lo:hi]))
            out = sim._flat(net.params).astype(np.float64)
            del net, fit
            return out
        xa, ya = (np.load(data)[k] for k in ("x_acc", "y_acc"))
        swap = np.r_[b // 2:b, 0:b // 2]  # the rows in another order
        sgd = {"full": sgd_step(0, b), "ragged": sgd_step(0, DP_RAGGED),
               "acc2": sgd_step(0, b, xa, ya, accum=2),
               "half0": sgd_step(0, b // 2), "half1": sgd_step(b // 2, b),
               "reordered": sgd_step(0, b, x[swap], y[swap])}
        del xa, ya
        init_net = models.resnet50(seed=0).init(device="cpu")
        init = {"params": sim._flat(init_net.params).astype(np.float64),
                "state": sim._flat(init_net.state).astype(np.float64)}
        del init_net
        mark("single")

        # ---- [dp-checkpoint], the 1-rank half, in this process, as soon
        # as the 2-rank run (its first scenario) has both steps verified
        deadline = time.monotonic() + DP_TIMEOUT
        while TrainingCheckpointer(ck).verified_steps() != \
                [DP_CKPT_STEPS, DP_SAVE_AT]:
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p in two.procs):
                two.wait()  # raises with the failing rank's output
                raise AssertionError("[dp-checkpoint] no verified steps "
                                     f"{DP_CKPT_STEPS} and {DP_SAVE_AT}")
            time.sleep(0.5)
        mark("checkpoint_written")
        ck_rec = {"launches": [], "decisions": []}

        def continue_from(net):
            pw = ParallelWrapper(net)
            for i in range(DP_SAVE_AT, DP_CKPT_STEPS):
                k1.launches = k1.bwd_launches = 0
                fe.reset_counters()
                pw.fit(DataSet(x[i * b:(i + 1) * b], y[i * b:(i + 1) * b]))
                torch.cuda.synchronize()
                ck_rec["launches"].append([k1.launches, k1.bwd_launches])
                ck_rec["decisions"].append(fe.counters())
            return sim._digest(net.params, net.state, net.updater_state)
        with TrainingCheckpointer(ck) as ckp:
            verified = ckp.verified_steps()
            resumed = models.resnet50(seed=1).init(device="cuda")
            if ckp.restore(resumed, step=DP_SAVE_AT) != DP_SAVE_AT:
                raise AssertionError("[dp-checkpoint] restore of step 2")
        with Deterministic():
            d_resume = continue_from(resumed)
            del resumed
            d_zip = continue_from(load_model(zip2, device="cuda"))
        dp_check_steps(ck_rec, "dp-checkpoint")
        if d_resume != d_zip:
            raise AssertionError("[dp-checkpoint] the restored step-2 state "
                                 "continued differs from the ZIP's")
        newest = max(verified)
        victim = os.path.join(ck, str(newest), "params.npz")
        with open(victim, "r+b") as f:
            f.truncate(os.path.getsize(victim) // 2)
        with TrainingCheckpointer(ck) as ckp:
            scan = ckp.scan_steps()
            back = models.resnet50(seed=1).init(device="cuda")
            got = ckp.restore(back)
            fallbacks = ckp.restore_fallbacks
        if got != DP_SAVE_AT or fallbacks != 1 or scan["torn"] != [newest]:
            raise AssertionError(f"[dp-checkpoint] fallback: restored {got}"
                                 f", {fallbacks} fallbacks, scan {scan}")
        eng = InferenceEngine(models.resnet50(seed=2).init(device="cuda"),
                              device="cuda")
        eng.warmup([b], checkpoint=ck)
        k1.launches = 0
        served = eng.output(x[:b])
        torch.cuda.synchronize()
        eng_k1 = k1.launches
        want = back.output(x[:b])
        if eng_k1 != LAUNCHES_PER_FORWARD or not np.array_equal(served,
                                                                want):
            raise AssertionError(f"[dp-checkpoint] engine warmed from the "
                                 f"checkpoint: {eng_k1} K1, bit-equal "
                                 f"{np.array_equal(served, want)}")
        del back, eng
        mark("checkpoint")
        two_raw = two.wait()
        two_res = [r["scenarios"] for r in two_raw]
        mark("two_ranks")
        one_res = one.wait()[0]["scenarios"]
        mark("one_rank")
        ref_res = ref.wait()[0]["scenarios"]
        mark("reference")

        def params_state(d, n):  # the gates read no other member
            with np.load(os.path.join(root, d, f"scn_{n}.npz")) as z:
                return {k: z[k] for k in ("params", "state")}
        flat = {n: params_state("two", n) for n in two_res[0]}
        flat.update({n: params_state("one", n) for n in one_res})
        truth = {n: params_state("ref", n)
                 for n in ("ref", "ref_ragged", "ref_acc2")}
    finally:
        for run in (ref, two, one):
            if run is not None:
                run.kill()  # a no-op for ranks that ended
        shutil.rmtree(root, ignore_errors=True)

    # ---- what was measured, then the gates ----
    t_wall = time.time()
    smi = smi_line()
    r0 = two_res[0]
    rows = {"gloo_2ranks": dp_row(r0["dp2"]),
            "nccl_1rank": dp_row(one_res["dp1"]),
            "zero1_overlap_2ranks": dp_row(r0["zero1"]),
            "zero1_acc2_2ranks": dp_row(r0["zero1_acc2"]),
            "tp_1x2": dp_row(r0["tp"]),
            "checkpoint_2ranks": dp_row(r0["ckpt"])}
    for k, v in rows.items():
        log(f"[dp-resnet50] {smi}: {k}: " + json.dumps(v))
    t_wall0 = t_wall - (time.perf_counter() - t0)
    spans = {n: (round(r["t_begin"] - t_wall0, 1),
                 round(r["t_end"] - t_wall0, 1)) for n, r in r0.items()}
    log(f"[dp] {smi}: the 2-rank spawn (s from the phase's start): torch "
        f"imported at {two_raw[0]['t_worker'] - t_wall0:.1f}, scenarios "
        f"{spans}")
    log(f"[dp] {smi}: phase clock (s from its start) {clock}; the float64 "
        f"reference ended {clock['reference']:.1f} s in (started "
        f"{t0 - dp_ref['t0']:.1f} s before the phase), its steps (ms) "
        + json.dumps({n: r["step_ms"] for n, r in ref_res.items()}))
    e1 = dp_errors(single_fit, truth["ref"], init)
    e1r = dp_errors(single_rag, truth["ref_ragged"], init)
    against = {"dp2": "ref", "dp1": "ref", "zero1": "ref",
               "zero1_acc2": "ref_acc2", "tp": "ref",
               "dp2_ragged": "ref_ragged"}
    src = {**flat}
    errs = {n: dp_errors(src[n], truth[t], init) for n, t in against.items()}
    log(f"[dp-resnet50] {smi}: change from init against float64 on the "
        f"CPU, rel_err (params, BN state): single-process card fit {e1}, "
        f"ragged {e1r}; " + json.dumps(errs))
    for n, t in against.items():
        scale = e1r if t == "ref_ragged" else e1
        allowed = {k: max(DP_GATE_FLOOR, DP_GATE_FACTOR * scale[k])
                   for k in scale}
        if any(errs[n][k] > allowed[k] for k in allowed):
            raise AssertionError(f"[dp {n}] against float64 on the CPU: "
                                 f"{errs[n]}, allowed {allowed}")
    p0 = init["params"]
    sgd_against = {"sgd_dp2": "full", "sgd_dp1": "full", "sgd_tp": "full",
                   "sgd_ragged": "ragged", "sgd_zero1_acc2": "acc2"}
    sgd_errs = {n: rel_err(flat[n]["params"].astype(np.float64) - p0,
                           sgd[t] - p0) for n, t in sgd_against.items()}
    faults = {"local_count": rel_err(2 * (sgd["full"] - p0),
                                     sgd["full"] - p0),
              "local_bn": rel_err((sgd["half0"] + sgd["half1"]) / 2 - p0,
                                  sgd["full"] - p0)}
    reorder = rel_err(sgd["reordered"] - p0, sgd["full"] - p0)
    log(f"[dp-resnet50] {smi}: one SGD step (lr {DP_SGD_LR}) against the "
        f"single-process card step, rel_err of the params' change: "
        f"{json.dumps(sgd_errs)}; its rows reordered in one process (the "
        f"control) {reorder}; the faults read {json.dumps(faults)} (gate "
        f"{DP_SGD_GATE})")
    if reorder > DP_SGD_GATE or any(v > DP_SGD_GATE
                                    for v in sgd_errs.values()):
        raise AssertionError(f"[dp SGD] against the single-process step: "
                             f"{sgd_errs}, the control {reorder}, allowed "
                             f"{DP_SGD_GATE}")
    if any(v <= DP_SGD_GATE for v in faults.values()):
        raise AssertionError(f"[dp SGD] the gate passes a fault: {faults}")
    for name, rec in list(r0.items()) + [("dp1", one_res["dp1"]),
                                         ("sgd_dp1", one_res["sgd_dp1"])]:
        per = (2 * LAUNCHES_PER_FORWARD,) * 2 if name.endswith(
            "zero1_acc2") else (LAUNCHES_PER_FORWARD,) * 2
        dp_check_steps(rec, f"dp {name}", per)
    for name in r0:
        if r0[name]["digests"] != two_res[1][name]["digests"]:
            raise AssertionError(f"[dp] {name}: the two ranks' params "
                                 "differ after a step")
    # the Adam shards stay on their ranks between steps: a ZeRO-1 fit
    # gathers only the params' chunks (one all-gather a bucket), a TP fit
    # only the head's columns
    zero_ag = [c["all_gather"] for c in r0["zero1"]["fit_calls"]]
    tp_ag = [c["all_gather"] for c in r0["tp"]["fit_calls"]]
    if not all(r0["zero1"]["held"]) or any(r0["dp2"]["held"]) or \
            zero_ag != [r0["zero1"]["counters"]["buckets"]] * DP_STEPS or \
            tp_ag != [1] * DP_STEPS:
        raise AssertionError(f"[dp-zero1] the shards were not kept between "
                             f"steps: held {r0['zero1']['held']}, a fit's "
                             f"all-gathers {zero_ag} (TP {tp_ag})")
    if r0["zero1"]["digests"] != r0["dp2"]["digests"]:
        raise AssertionError("[dp-zero1] params differ from the replicated "
                             "2-rank run's")
    c_rep, c_zero = r0["dp2"]["counters"], r0["zero1"]["counters"]
    adam_rep = c_rep["updater_state_bytes_per_rank"]
    adam_zero = c_zero["updater_state_bytes_per_rank"]
    if not 0.45 <= adam_zero / adam_rep <= 0.55:
        raise AssertionError(f"[dp-zero1] per-rank Adam state {adam_zero} "
                             f"against the replicated {adam_rep}")
    tp_c = r0["tp"]["counters"]
    log(f"[dp-resnet50] {smi}: every gate held; 53 K1 + 53 K2 a step on "
        "every rank, fused only; the ranks bit-identical after every step")
    log(f"[dp-zero1] {smi}: bit for bit the replicated 2-rank run; Adam "
        f"state per rank {adam_zero} B against {adam_rep} B replicated "
        f"({adam_zero / adam_rep:.4f}), kept between steps; buckets "
        f"{c_zero['buckets']}, all-gathers a fit {zero_ag}")
    log(f"[dp-tp] {smi}: the [2048, 1000] head over the model axis: "
        f"all-gathers a fit {tp_ag} (the harness's reads of the params "
        f"gather the rest: {tp_c['calls']['all_gather']} in all), error "
        f"{errs['tp']}")
    sv = r0["ckpt"]
    log(f"[dp-checkpoint] {smi}: async saves at steps {DP_SAVE_AT} and "
        f"{DP_CKPT_STEPS}: {sv['save_bytes']} B a step, save latency (to "
        f"the manifest) {sv['save_latency_s']} s, the step loop's save "
        f"calls {sv.get('save_call_ms')} ms; verified {verified}; 2 -> 1 "
        f"rank restore continued bit for bit; newest torn -> fell back "
        f"to step {got}; InferenceEngine warmed from the directory: batch "
        f"{b} bit-equal, {eng_k1} K1")

    def k12(recs):
        return [sum(step[j] for r in recs for step in r["launches"])
                for j in (0, 1)]
    return {"launches": {
        "dp_resnet50": k12([r0["dp2"], r0["dp2_ragged"], one_res["dp1"],
                            single_rec, rag_rec, r0["sgd_dp2"],
                            r0["sgd_ragged"], one_res["sgd_dp1"]]),
        "dp_zero1": k12([r0["zero1"], r0["zero1_acc2"],
                         r0["sgd_zero1_acc2"]]),
        "dp_tp": k12([r0["tp"], r0["sgd_tp"]]),
        "dp_checkpoint": [a + c for a, c in zip(k12([r0["ckpt"], ck_rec]),
                                                (eng_k1, 0))]},
        "errors": errs, "sgd_errors": sgd_errs, "sgd_faults": faults,
        "rows": rows, "clock": clock}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch import environment as env
    from deeplearning4j_tpu_torch import models
    from deeplearning4j_tpu_torch.kernels import _build as build
    from deeplearning4j_tpu_torch.kernels import affine_act as k1
    from deeplearning4j_tpu_torch.kernels import decode_attention as k9
    from deeplearning4j_tpu_torch.kernels import flash_attention as k3
    from deeplearning4j_tpu_torch.kernels import layer_norm_act as k6
    from deeplearning4j_tpu_torch.kernels import lstm_cell as k8
    from deeplearning4j_tpu_torch.kernels import multiquery_decode as k10
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk
    from deeplearning4j_tpu_torch.nn import graph
    from deeplearning4j_tpu_torch.ops import fused_epilogues as fe
    from deeplearning4j_tpu_torch.serving import server as server_mod

    phase_toolchain(build)
    phase_build(build)
    dp_ref = dp_reference_start(models)
    # the reference process must not outlive a phase that fails before
    # phase_dp reads it
    atexit.register(dp_ref["run"].kill)
    lenet_calls = lenet_epilogue_calls(models, LENET_BATCH)
    kern = phase_kernel(k1, lenet_calls)
    kbwd = phase_kernel_bwd(k1, lenet_calls)
    served = phase_serve(k1, fe, env, models, graph)
    forwards = served["forwards"] + phase_server(k1, server_mod,
                                                 served["net"])
    serve_launches = k1.launches
    if serve_launches == 0 or \
            serve_launches != forwards * LAUNCHES_PER_FORWARD:
        raise AssertionError(f"serving path: {serve_launches} K1 launches "
                             f"for {forwards} forwards")
    # every decision on the card launched K1 (the CPU reference forwards
    # count as fallback_platform, by design); serving runs no backward
    if fe.counters()["fused"] != serve_launches or \
            fe.counters()["fallback_act"] or k1.bwd_launches:
        raise AssertionError(f"serving path decisions: {fe.counters()}, "
                             f"{k1.bwd_launches} K2 launches")
    del served
    trained = phase_train(k1, fe, env, models, graph)
    train_eval = phase_train_eval(k1, fe, graph, trained["net"],
                                  trained.pop("batch"))
    transfer = phase_transfer(k1, fe, env, graph, trained["net"])
    nchw = phase_nchw(k1, fe, env)
    lenet_row = phase_lenet(k1, fe, env, models)
    lenet_train, lenet_test = lenet_row.pop("train"), lenet_row.pop("test")
    center = phase_lenet_center(k1, fe, env, models, lenet_train, lenet_test)
    # one batch-32 forward's (training step's) 53 K1 (K2) calls, timed per
    # (rows, C, act) in phases 3 and 6
    calls = k1_path_calls(trained["net"], 32)
    t, tb = kern["times"], kbwd["times"]
    ms = sum(t[c][0] for c in calls)
    ms2 = sum(tb[c][0] for c in calls)
    bf16 = phase_train_bf16(k1, fe, env, models, graph, trained, (ms, ms2))
    del trained["grads_64"]
    accum = phase_train_accum(k1, fe, env, graph, trained)
    remat = phase_remat(k1, fe, env, trained)
    solver = phase_lenet_solver(k1, fe, env, models, lenet_train)
    on_device = phase_lenet_on_device(k1, fe, env, models, lenet_train,
                                      lenet_test, lenet_row["step_ms"])
    rr = remat["rows"]
    modes_k = {"train_bf16": bf16["launches"], "train_accum": accum["launches"],
               **{f"remat_{m}": (rr[m]["k1"], rr[m]["k2"])
                  for m in REMAT_MODES},
               "lenet_solver": solver["launches"],
               "lenet_on_device": on_device["launches"]}
    if k3.launches:
        raise AssertionError(f"{k3.launches} K3 launches on the ResNet paths")
    katt = phase_kernel_attn(k3)
    served_bert = phase_bert(k1, k3, fa, env)
    kbwd_attn = phase_kernel_attn_bwd(k3)
    fitted = phase_bert_fit(k1, k3, fa, fe, env)
    klstm = phase_kernel_lstm(k8)
    served_lstm = phase_lstm_serve(k1, k3, k8, pk, env)
    kmods = {"k1": k1, "k3": k3, "k6": k6, "k8": k8, "k9": k9, "k10": k10}
    fit_lstm = phase_lstm_fit(kmods, pk, env)
    breadth = phase_rnn_breadth(kmods, pk, env)
    from deeplearning4j_tpu_torch.tools import profile_generate as pg
    # a decode step halfway through the bench's mix: each prompt's length
    # plus half the new tokens, the step's own token included
    path_lengths = [len(p) + pg.BENCH["max_new_tokens"] // 2 + 1
                    for p in pg.prompts(*pg.BENCH_PROMPTS)]
    kdec = phase_kernel_decode(k9, path_lengths)
    # a verify step halfway through each speculative mix: the rows cached
    # before the window (the prompt plus half the new tokens)
    spec_half = pg.PAGED["max_new_tokens"] // 2
    mq_lengths = {
        MQ_PATH_SHAPE: [pg.SYSTEM_PROMPT_LEN + spec_half] * MQ_PATH_SHAPE[0],
        MQ_GROW_SHAPE: [len(p) + pg.GROW["max_new_tokens"] // 2
                        for p in pg.prompts(*pg.GROW_PROMPTS)]}
    kmq = phase_kernel_mq(k10, k9, mq_lengths)
    counters = (k1, k3, k8, k9, k10, fa, pk)
    gen = phase_generate(counters, env)
    gen_server = phase_generate_server(counters, server_mod, gen["net"])
    paged = phase_generate_paged(counters, gen)
    spec = phase_generate_spec(counters, gen, paged)
    spec_server = phase_generate_spec_server(counters, server_mod,
                                             gen["net"])
    kln = phase_kernel_ln(k6)
    bert_ln = phase_bert_ln(k1, k3, k6, fa, fe, env)
    bert_ln_fit = phase_bert_ln_fit(k1, k3, k6, fa, fe, env,
                                    bert_ln.pop("sd"))
    ln_l, fit_ln = bert_ln["launches"], bert_ln_fit["launches"]
    bert_sd = bert_ln_fit.pop("sd")
    imported = phase_import(kmods, fa, fe, env)
    control = phase_sd_control(env)
    bf16_fit = phase_bert_bf16_fit(kmods, fa, fe, env, bert_sd,
                                   bert_ln_fit["row"])
    remat_bert = phase_bert_remat(kmods, fa, fe, env, bert_sd)
    bert_eval = phase_bert_eval(kmods, fa, fe, env, bert_sd)
    del bert_sd
    keras_imp = phase_keras_import(kmods, fe, env)
    keras_gold = phase_keras_golden(kmods, fe, env)
    keras_rn50 = phase_keras_resnet50(kmods, fe, env, graph)
    disagg = phase_disagg(counters, gen)
    sd_dec = phase_sd_decode(counters, env)
    int8_mm = phase_int8_mm(env, models)
    int8_rn = phase_int8_resnet50(kmods, fe, env, models)
    int8_gen = phase_int8_generate(counters, gen)
    int8_bert = phase_int8_bert(kmods, fa, fe, env)
    dp_paths = phase_dp(kmods, fe, env, models, dp_ref)["launches"]

    def dp_counts(k):
        return {p: c[0 if k == "k1" else 1] for p, c in dp_paths.items()}
    # the launches of the int8 paths, by kernel key of kernel_launches
    int8_paths = {"int8_resnet50": int8_rn["launches"],
                  "int8_generate_bench": int8_gen["launches"]["bench"],
                  "int8_generate_spec": int8_gen["launches"]["spec"],
                  "int8_bert": int8_bert["launches"]}

    def int8_counts(k):
        return {p: c.get(k, 0) for p, c in int8_paths.items()}
    log("[int8] " + json.dumps({
        "mm": int8_mm, "resnet50": {k: v for k, v in int8_rn.items()
                                    if k != "launches"},
        "generate": {k: int8_gen[k] for k in (
            "walk", "cache_bytes", "pool_bytes", "shipment_bytes", "pads")},
        "generate_rows": {t: {k: r[k] for k in (
            "tokens_per_s", "wall_ms_median", "ttft_ms_p50", "ttft_ms_p99",
            "tpot_ms_p50", "tpot_ms_p99", "device_ms", "device_busy_share",
            "k3_device_ms", "k9_device_ms", "k10_device_ms")}
            for t, r in int8_gen["rows"].items()},
        "bert": {k: v for k, v in int8_bert.items() if k != "launches"},
        "launches": int8_paths}, default=str))
    # the launches of the Keras paths, by kernel key of kernel_launches
    keras_paths = {"keras_import": keras_imp["launches"],
                   "keras_golden": keras_gold["launches"],
                   "keras_resnet50_serve": keras_rn50["serve_launches"],
                   "keras_resnet50_fit": keras_rn50["fit_launches"]}

    def keras_counts(k):
        return {p: c[k] for p, c in keras_paths.items()}
    # the launches of this slice's paths, by kernel key of
    # profile_bert.launch_counts (k4 and k5: the fused backward's launches
    # that wrote dq, and dk and dv)
    sd_paths = {"import": imported["launches"],
                "bert_bf16_fit": bf16_fit["launches"],
                **{f"bert_remat_{t}": r["launches"]
                   for t, r in remat_bert["rows"].items()},
                "bert_eval": bert_eval["launches"]}

    def sd_counts(k):
        return {p: c[k] for p, c in sd_paths.items()}
    no_sd = {p: 0 for p in sd_paths}
    bf16_rows = {k: {"ms_per_step": bf16_fit["split"][k],
                     "float32_ms_per_step": bf16_fit["f32_split"][k],
                     "bound_ms_per_step": bf16_fit["bounds"][k]["ms"],
                     "bound_by": bf16_fit["bounds"][k]["by"],
                     "launches_per_step": bf16_fit["bf16"][k]
                     // bf16_fit["steps"]}
                 for k in ("k1", "k2", "k3", "bwd", "k6", "k7")}

    def ln_paths(k):
        return {"bert_ln_serve": ln_l[k], "bert_ln_fit": fit_ln[k]}
    no_ln = {"bert_ln_serve": 0, "bert_ln_fit": 0}

    plain = sum(t[c][1] for c in calls)
    lib = sum(t[(r, c, "identity")][2] for r, c, _ in calls)
    host = sum(t[c][3] for c in calls)
    bound = sum(k1.bound_ms(r, c, 4, a) for r, c, a in calls)
    t_bytes = sum(k1.bytes_moved(r, c, 4) for r, c, _ in calls)
    t_ops = sum(k1.flops(r, c, a) for r, c, a in calls) * (
        k1.H100_BYTES_PER_S / k1.H100_F32_FLOPS_PER_S)
    plain2 = sum(tb[c][1] for c in calls)
    host2 = sum(tb[c][2] for c in calls)
    bound2 = sum(k1.bound_ms_bwd(r, c, 4, a) for r, c, a in calls)
    b_bytes = sum(k1.bytes_moved_bwd(r, c, 4) for r, c, _ in calls)
    b_ops = sum(k1.flops_bwd(r, c, a) for r, c, a in calls) * (
        k1.H100_BYTES_PER_S / k1.H100_F32_FLOPS_PER_S)
    log(f"[summary] one batch-32 float32 forward: {len(calls)} K1 calls, "
        f"{ms:.4f} ms on the device (plain {plain:.4f}, addcmul {lib:.4f}, "
        f"bound {bound:.4f}); host enqueue {host:.4f} ms")
    log(f"[summary] one batch-32 float32 training step: {len(calls)} K2 "
        f"calls, {ms2:.4f} ms on the device (plain {plain2:.4f}, bound "
        f"{bound2:.4f}); host enqueue {host2:.4f} ms")
    t3 = katt["times"][(32, 12, 128, 128, 64)]
    ms3, plain3, lib3, host3, bound3 = (BERT_LAYERS * t for t in t3[:5])
    by3 = t3[5]
    k3_b16 = katt["bert_b32"]["bfloat16"]
    log(f"[summary] one batch-32 float32 BERT-base forward: {BERT_LAYERS} K3 "
        f"calls, {ms3:.4f} ms on the device (plain {plain3:.4f}, "
        f"scaled_dot_product_attention {lib3:.4f}, bound {bound3:.4f}, "
        f"{by3}; {bound3 / ms3:.1%} of the bound); host enqueue "
        f"{host3:.4f} ms; bfloat16 a call {k3_b16['ms']:.5f} ms (SDPA "
        f"{k3_b16['library_ms']:.5f}, bound {k3_b16['bound_ms']:.5f})")
    # K4 + K5: one fused launch per layer and step, timed in float32 (the
    # path's dtype) and bfloat16
    tb32, tb16 = kbwd_attn["times"]["float32"], kbwd_attn["times"]["bfloat16"]
    per_step = {k: BERT_LAYERS * v for k, v in tb32.items()
                if k == "ms" or k.endswith("_ms")}
    log(f"[summary] one batch-32 float32 BERT-base fine-tune step: "
        f"{BERT_LAYERS} fused K4+K5 calls, {per_step['ms']:.4f} ms on the "
        f"device ({tb32['ms']:.5f} a call; dq only {per_step['dq_only_ms']:.4f},"
        f" dk/dv only {per_step['dkv_only_ms']:.4f}; plain "
        f"{per_step['plain_ms']:.4f}, bound {per_step['bound_ms']:.4f}, "
        f"{tb32['bound_by']}); the backward of scaled_dot_product_attention "
        f"(dq, dk, dv) {per_step['library_ms']:.4f}; host enqueue "
        f"{per_step['host_ms']:.4f} ms; bfloat16 a call {tb16['ms']:.5f} ms "
        f"(SDPA backward {tb16['library_ms']:.5f}, bound "
        f"{tb16['bound_ms']:.5f}, {tb16['bound_by']})")
    fit_l = fitted["launches"]
    # one batch-32 request: 256 steps of each of the two layers
    t8 = [klstm["times"][sh] for sh in LSTM_PATH_SHAPES]
    ms8, plain8, lib8, host8, bound8 = (
        LSTM_T_BUCKET * (a + b) for a, b in zip(t8[0][:5], t8[1][:5]))
    b8_bytes = sum(k8.bytes_moved(B, F, U, 4) for B, F, U in LSTM_PATH_SHAPES)
    b8_ops = sum(k8.flops(B, F, U) for B, F, U in LSTM_PATH_SHAPES) * (
        k8.H100_BYTES_PER_S / k8.H100_F32_FLOPS_PER_S)
    by8 = "bytes" if b8_bytes >= b8_ops else "operations"
    floor8 = LSTM_T_BUCKET * sum(klstm["shapes"][sh]["floor_ms"]
                                 for sh in LSTM_PATH_SHAPES)
    log(f"[summary] one batch-32 float32 TextGenerationLSTM request (200 "
        f"characters, time bucket {LSTM_T_BUCKET}): {2 * LSTM_T_BUCKET} K8 "
        f"calls, {ms8:.4f} ms on the device (plain {plain8:.4f}, "
        f"torch.lstm_cell {lib8:.4f}, bound {bound8:.4f}, {by8}; the same "
        f"launches of an empty kernel {floor8:.4f}); host enqueue "
        f"{host8:.4f} ms; a whole-sequence torch.nn.LSTM "
        f"{served_lstm['cudnn_ms']:.4f} ms")
    rows = gen["rows"]
    srows = spec["rows"]
    gen_l = {"generate": rows["bench"]["launches"],
             "generate_grow": rows["grow"]["launches"],
             "generate_server": gen_server["launches"],
             "generate_paged": paged["row"]["launches"],
             "generate_spec": {k: srows["spec"]["launches"][k]
                               + srows["spec_other_draft"]["launches"][k]
                               for k in ("k3", "k9", "k10")},
             "generate_spec_grow": srows["spec_grow"]["launches"],
             "generate_spec_server": spec_server["launches"],
             "disagg_colocated": disagg["launches"]["colocated"],
             "disagg_split": disagg["launches"]["split"],
             "disagg_router": disagg["router"]["launches"],
             "sd_decode": sd_dec["launches"]}
    # the output() request of [generate] goes through InferenceEngine, not
    # the batcher: a path of its own
    k3_gen = {k: v["k3"] for k, v in gen_l.items()}
    k3_gen["generate_output"] = gen["output_launches"][0]
    k9_gen = {k: v["k9"] for k, v in gen_l.items()}
    k9_gen["generate_output"] = gen["output_launches"][1]
    k10_gen = {k: v["k10"] for k, v in gen_l.items()}
    k10_gen["generate_output"] = 0
    no_gen = {k: 0 for k in k3_gen}
    # one decode step of the bench's mix: 3 K9 calls at the path's shape
    t9 = kdec["times"][DECODE_PATH_SHAPE]
    ms9, plain9, lib9, host9, bound9 = (GEN_LAYERS * t for t in t9[:5])
    by9 = t9[5]
    t9l = kdec["times"][DECODE_LONG_SHAPE]
    floor9 = GEN_LAYERS * kdec["floors"][DECODE_PATH_SHAPE]
    log(f"[summary] one float32 decode step of the generative model (8 "
        f"slots, cache 128, lengths {min(path_lengths)}..."
        f"{max(path_lengths)}): {GEN_LAYERS} K9 calls, {ms9:.4f} ms on the "
        f"device (plain {plain9:.4f}, scaled_dot_product_attention "
        f"{lib9:.4f}, bound {bound9:.4f}, {by9}; the same launches of an "
        f"empty kernel {floor9:.4f}); host enqueue {host9:.4f} ms; at "
        f"{DECODE_LONG_SHAPE}: {t9l[0]:.4f} ms (bound {t9l[4]:.4f}, SDPA "
        f"{t9l[2]:.4f}, empty kernel "
        f"{kdec['floors'][DECODE_LONG_SHAPE]:.4f})")
    # one verify step of the speculative mix: 3 K10 calls at the path's
    # shape
    t10 = kmq["times"][MQ_PATH_SHAPE]
    ms10, plain10, lib10, host10, bound10 = (GEN_LAYERS * t for t in t10[:5])
    by10 = t10[5]
    t10g, t10l = kmq["times"][MQ_GROW_SHAPE], kmq["times"][MQ_LONG_SHAPE]
    floor10 = GEN_LAYERS * kmq["floors"][MQ_PATH_SHAPE]
    log(f"[summary] one float32 verify step of the speculative mix (8 slots,"
        f" cache 128, k = {pg.SPECULATE_K}, lengths {mq_lengths[MQ_PATH_SHAPE][0]}"
        f" before the window): {GEN_LAYERS} K10 calls, {ms10:.4f} ms on the "
        f"device (plain {plain10:.4f}, scaled_dot_product_attention "
        f"{lib10:.4f}, bound {bound10:.4f}, {by10}; the same launches of an "
        f"empty kernel {floor10:.4f}); host enqueue {host10:.4f} ms; at "
        f"{MQ_GROW_SHAPE}: {t10g[0]:.4f} ms (bound {t10g[4]:.4f}, SDPA "
        f"{t10g[2]:.4f}); at {MQ_LONG_SHAPE}: {t10l[0]:.4f} ms (bound "
        f"{t10l[4]:.4f}, SDPA {t10l[2]:.4f}, empty kernel "
        f"{kmq['floors'][MQ_LONG_SHAPE]:.4f})")
    t6, t7 = kln["times"]["fwd"], kln["times"]["bwd"]
    ms6, plain6, lib6, host6, bound6 = (LN_SITES * t for t in t6)
    ms7, plain7, lib7, host7, bound7 = (LN_SITES * t for t in t7)
    r6, c6 = LN_PATH_SHAPE
    by6 = "bytes" if k6.bytes_moved(r6, c6, 4) / k6.H100_BYTES_PER_S >= \
        k6.flops(r6, c6, "identity") / k6.H100_F32_FLOPS_PER_S \
        else "operations"
    by7 = "bytes" if k6.bytes_moved_bwd(r6, c6, 4) / k6.H100_BYTES_PER_S >= \
        k6.flops_bwd(r6, c6, "identity") / k6.H100_F32_FLOPS_PER_S \
        else "operations"
    log(f"[summary] one batch-32 float32 fused BERT-base forward: {LN_SITES} "
        f"K6 calls, {ms6:.4f} ms on the device (plain {plain6:.4f}, "
        f"F.layer_norm {lib6:.4f}, bound {bound6:.4f}, {by6}); host enqueue "
        f"{host6:.4f} ms")
    b7 = kln["times"]["bwd_bfloat16"]
    log(f"[summary] one batch-32 float32 fused BERT-base fine-tune step: "
        f"{LN_SITES} K7 calls, {ms7:.4f} ms on the device (plain "
        f"{plain7:.4f}, native_layer_norm_backward {lib7:.4f}, bound "
        f"{bound7:.4f}, {by7}, {bound7 / ms7:.1%} of it; the same launches "
        f"of an empty kernel "
        f"{LN_SITES * kln['times']['bwd_float32']['floor_ms']:.4f}); host "
        f"enqueue {host7:.4f} ms; bfloat16 a call {b7['ms']:.5f} ms "
        f"(native_layer_norm_backward {b7['library_ms']:.5f}, bound "
        f"{b7['bound_ms']:.5f})")
    g1, g2 = kln["gelu"]["fwd"], kln["gelu"]["bwd"]
    log(f"[summary] the same forward's {BERT_LAYERS} K1 geluexact calls at "
        f"{LN_GELU_SHAPE}: {BERT_LAYERS * g1[0]:.4f} ms (plain "
        f"{BERT_LAYERS * g1[1]:.4f}, F.gelu(x + b) {BERT_LAYERS * g1[2]:.4f},"
        f" bound {BERT_LAYERS * g1[4]:.4f}); the step's {BERT_LAYERS} K2 "
        f"calls {BERT_LAYERS * g2[0]:.4f} ms (bound "
        f"{BERT_LAYERS * g2[4]:.4f})")

    def gelu_row(t, lib=True):
        return {"shape": list(LN_GELU_SHAPE), "act": "geluexact",
                "calls": BERT_LAYERS, "ms": BERT_LAYERS * t[0],
                "plain_ms": BERT_LAYERS * t[1],
                "library_ms": BERT_LAYERS * t[2] if lib else None,
                "bound_ms": BERT_LAYERS * t[4], "max_abs_err": t[5]}
    def rnn_paths(k):
        return {"lstm_fit": fit_lstm["fit_launches"][k],
                "lstm_fit_output": fit_lstm["output_launches"][k],
                "rnn_breadth": breadth["launches"][k]}

    def lstm_paths(k):
        return {"lstm_serve": 0, "lstm_stream": 0, **rnn_paths(k),
                **no_gen, **no_ln}
    kernel_paths = ["serve", "train", "bert_serve", "bert_fit",
                    *lstm_paths("k1")]
    bwd_timed_as = (
        "K4 and K5 are one fused kernel, and the main path's time is in the "
        "K4 row only: ms is the device time of one float32 fused call (dq, "
        "dk and dv) at BERT-base batch 32 (B=32, H=12, T=128, d=64, ragged "
        "key bias, head-split operands) times the 12 calls of one fine-tune "
        "step; plain_ms the dq and dk/dv plain versions; bound_ms the fused "
        "call's (10 G T^2 d flops); library_ms the backward of "
        "torch.nn.functional.scaled_dot_product_attention with the same "
        "float mask (one torch.autograd.grad of its output giving dq, dk and "
        "dv, its forward outside the timed window), all times 12; host_ms "
        "the wrapper's enqueue time over the same calls; bfloat16 one call "
        "at the same shape; launches count the launches that wrote the "
        "row's outputs, fused_launches every launch of the kernel on the "
        "fine-tune paths")
    dkv_timed_as = (
        "K5's outputs come from K4's fused launch on the main path, whose "
        "time is in the K4 row only; this row's ms is the same kernel asked "
        "for dk and dv alone (flash_attention_bwd_dkv, a call the main path "
        "does not make) at the K4 row's shape times 12, plain_ms its plain "
        "version, bound_ms the dk/dv call's (8 G T^2 d flops), library_ms "
        "one torch.autograd.grad of SDPA's output for k and v alone")
    print(json.dumps({"kernels": [{
        "name": "K1 affine_act", "checked": True, "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/affine_act.cu",
        "replaces": "deeplearning4j_tpu/ops/fused_epilogues.py:167",
        "launches": serve_launches + trained["launches"][0]
        + train_eval["launches"][0] + transfer["launches"][0]
        + transfer["eval_launches"][0] + nchw["launches"][0]
        + lenet_row["launches"][0] + lenet_row["eval_launches"][0]
        + center["launches"][0] + ln_l["k1"] + fit_ln["k1"]
        + sum(v[0] for v in modes_k.values()) + sum(sd_counts("k1").values())
        + sum(keras_counts("k1").values()) + sum(int8_counts("k1").values())
        + sum(dp_counts("k1").values()),
        "launches_by_path": {"serve": serve_launches,
                             "train": trained["launches"][0],
                             "train_eval": train_eval["launches"][0],
                             "transfer_fit": transfer["launches"][0],
                             "transfer_eval": transfer["eval_launches"][0],
                             "lenet_center_fit": center["launches"][0],
                             "nchw_block": nchw["launches"][0],
                             "lenet_fit": lenet_row["launches"][0],
                             "lenet_eval": lenet_row["eval_launches"][0],
                             "bert_serve": 0, "bert_fit": 0,
                             **lstm_paths("k1"), **ln_paths("k1"),
                             **{k: v[0] for k, v in modes_k.items()},
                             **sd_counts("k1"), **keras_counts("k1"),
                             **int8_counts("k1"), **dp_counts("k1")},
        "int8_resnet50": {k: int8_rn[k] for k in (
            "k1_per_forward", "wall_ms", "device_ms", "busy_share",
            "rel_err", "gate_delta", "gate_passed", "weight_bytes_f32",
            "weight_bytes_int8")},
        "max_abs_err": max(*kern["max_err"].values(),
                           bf16["path_k1_max_err"]),
        "max_abs_err_float32": kern["max_err"][torch.float32],
        "max_abs_err_bfloat16": kern["max_err"][torch.bfloat16],
        "max_abs_err_float16": kern["max_err"][torch.float16],
        "occupancy": kern["occupancy"],
        "ms": ms, "plain_ms": plain, "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib, "host_ms": host,
        "bert_gelu": dict(gelu_row(g1), library="F.gelu(x + b)"),
        "keras_resnet50": {
            "k1_per_forward": KERAS_RN50_K1,
            "latency_ms_batch32": keras_rn50["latency_ms"],
            "rel_err_vs_cpu": keras_rn50["rel_err"],
            "import_s": keras_rn50["import_s"]},
        "keras_import": {n: {k: r[k] for k in (
            "k1", "k8", "rel_err_vs_cpu", "rel_err_vs_recorded")}
            for n, r in keras_imp["rows"].items()},
        "bert_bf16_fit": bf16_rows["k1"],
        "lenet_step_calls": lenet_step_calls(kern),
        "train_bf16": {k: bf16[k] for k in (
            "step_ms", "images_per_s", "device_ms", "busy_share",
            "k1_prof_ms", "path_k1_ms", "path_k1_bound_ms",
            "path_k1_max_err", "losses", "cpu_losses", "ref_share",
            "f32_ref_share", "f32_band", "fused_ms")},
        "remat": {m: {k: r[k] for k in ("k1", "k2", "peak_bytes",
                                        "residual_bytes",
                                        "activation_bytes")}
                  for m, r in rr.items()},
        "lenet_solver": {k: solver[k] for k in (
            "evaluations", "history", "cpu_history", "worst_rel_err",
            "branch")},
        "timed_as": "device time summed over the 53 calls of one batch-32 "
                    "float32 ResNet-50 forward; library_ms is torch.addcmul "
                    "(the affine alone) at the same shapes; host_ms is the "
                    "wrapper's enqueue time over the same calls; bert_gelu "
                    "is the 12 bias + exact-GELU calls of one batch-32 "
                    "fused BERT-base forward",
    }, {
        "name": "K2 affine_act_bwd", "checked": True, "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/affine_act_bwd.cu",
        "replaces": "deeplearning4j_tpu/ops/fused_epilogues.py:179",
        "launches": trained["launches"][1] + transfer["launches"][1]
        + nchw["launches"][1] + lenet_row["launches"][1]
        + center["launches"][1] + fit_ln["k2"]
        + sum(v[1] for v in modes_k.values()) + sum(sd_counts("k2").values())
        + sum(keras_counts("k2").values()) + sum(int8_counts("k2").values())
        + sum(dp_counts("k2").values()),
        "launches_by_path": {"serve": 0, "train": trained["launches"][1],
                             "train_eval": 0,
                             "transfer_fit": transfer["launches"][1],
                             "transfer_eval": 0,
                             "lenet_center_fit": center["launches"][1],
                             "nchw_block": nchw["launches"][1],
                             "lenet_fit": lenet_row["launches"][1],
                             "lenet_eval": 0,
                             "bert_serve": 0, "bert_fit": 0,
                             **lstm_paths("k2"), **ln_paths("k2"),
                             **{k: v[1] for k, v in modes_k.items()},
                             **sd_counts("k2"), **keras_counts("k2"),
                             **int8_counts("k2"), **dp_counts("k2")},
        "max_abs_err": max(kbwd["max_err"]["dx_float32"],
                           kbwd["max_err"]["dx_bfloat16"],
                           kbwd["max_err"]["dx_float16"],
                           kbwd["max_err"]["dscale_dshift"],
                           bf16["path_k2_max_err"]),
        "max_abs_err_dx_float32": kbwd["max_err"]["dx_float32"],
        "max_abs_err_dx_bfloat16": kbwd["max_err"]["dx_bfloat16"],
        "max_abs_err_dx_float16": kbwd["max_err"]["dx_float16"],
        "max_abs_err_dscale_dshift": kbwd["max_err"]["dscale_dshift"],
        "deterministic": True,
        "cuda_kernels_a_call": max(kbwd["per_call"].values()),
        "kernels_per_call_by_ctas": kbwd["per_call"],
        "occupancy": kbwd["occupancy"],
        "ms": ms2, "plain_ms": plain2, "bound_ms": bound2,
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": None, "host_ms": host2,
        "dy_copies_per_step": trained["dy_copies"],
        "lenet": {k: lenet_row[k] for k in (
            "steps", "accuracy", "step_ms", "images_per_s", "device_ms",
            "busy_share", "profiled_step_ms", "k1_ms", "k2_ms",
            "loss_rel_err", "grad_rel_err", "source")},
        "lenet_step_calls": lenet_step_calls(kbwd),
        "train_bf16": {"path_k2_ms": bf16["path_k2_ms"],
                       "path_k2_bound_ms": bf16["path_k2_bound_ms"],
                       "path_k2_max_err": bf16["path_k2_max_err"],
                       "path_k2_sum_rel": bf16["path_k2_sum_rel"],
                       "k2_prof_ms": bf16["k2_prof_ms"],
                       "grad_worst_ratio": bf16["grad_worst"],
                       "fused_vs_unfused": bf16["parity"]},
        "train_accum": {k: accum[k] for k in (
            "step_ms", "peak_bytes", "peak_bytes_b32", "grad_worst")},
        "lenet_on_device": {k: on_device[k] for k in (
            "step_ms", "accuracy", "loss_rel_err", "syncs")},
        "transfer": {k: transfer[k] for k in (
            "k1_per_forward", "k2_per_step", "step_ms", "device_ms",
            "busy_share", "loss_rel_err", "grad_worst_ratio", "accuracy")},
        "lenet_center": {k: center[k] for k in (
            "steps", "accuracy", "step_ms", "loss_rel_err",
            "center_rel_err")},
        "train_eval": {k: train_eval[k] for k in (
            "accuracy", "accuracy_cpu", "ties")},
        "bert_gelu": gelu_row(g2, lib=False),
        "keras_resnet50_fit": {k: keras_rn50[k] for k in (
            "step_ms", "device_ms", "k1_ms", "k2_ms", "busy_share",
            "loss_rel_err", "losses", "grad_worst")},
        "keras_resnet50_k2_per_step": KERAS_RN50_K2,
        "keras_golden": {k: keras_gold[k] for k in (
            "worst_band_share", "losses")},
        "bert_bf16_fit": bf16_rows["k2"],
        "timed_as": "device time summed over the 53 calls of one batch-32 "
                    "float32 ResNet-50 training step; no single PyTorch "
                    "call computes (dx, dscale, dshift), so library_ms is "
                    "null",
    }, {
        "name": "K3 flash_attn_fwd", "checked": True, "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "deeplearning4j_tpu/ops/flash_attention.py:114",
        "launches": served_bert["launches"] + fit_l[0]
        + sum(k3_gen.values()) + ln_l["k3"] + fit_ln["k3"]
        + sum(sd_counts("k3").values()) + sum(int8_counts("k3").values()),
        "launches_by_path": {"serve": 0, "train": 0,
                             "bert_serve": served_bert["launches"],
                             "bert_fit": fit_l[0], "lstm_serve": 0,
                             "lstm_stream": 0, **rnn_paths("k3"), **k3_gen,
                             **ln_paths("k3"), **sd_counts("k3"),
                             **keras_counts("k3"), **int8_counts("k3")},
        "int8_bert": {"k3_per_forward": BERT_LAYERS,
                      "wall_ms": int8_bert["row"]["wall_ms_median"],
                      "f32_wall_ms": int8_bert["f32_row"]["wall_ms_median"],
                      "rel_err_vs_cpu": int8_bert["rel_err_vs_cpu"],
                      "rel_err_vs_f32": int8_bert["rel_err_vs_f32"]},
        "max_abs_err": katt["max_err"]["float32"],
        "max_abs_err_float32": katt["max_err"]["float32"],
        "max_ulp_bfloat16": katt["max_err"]["ulp_bfloat16"],
        "max_ulp_float16": katt["max_err"]["ulp_float16"],
        "deterministic": True,
        "ms": ms3, "plain_ms": plain3, "bound_ms": bound3, "bound_by": by3,
        "library_ms": lib3, "host_ms": host3,
        "occupancy": katt["bert_b32"]["float32"]["occupancy"],
        "bfloat16": k3_b16,
        "bert_bf16_fit": bf16_rows["k3"],
        "bert_rel_err_vs_cpu": served_bert["rel_err"],
        "timed_as": "device time of one float32 call at BERT-base batch 32 "
                    "(B=32, H=12, T=128, d=64, ragged key bias) times the 12 "
                    "calls of one forward; library_ms is "
                    "torch.nn.functional.scaled_dot_product_attention with "
                    "the same float mask at the same shapes; host_ms is the "
                    "wrapper's enqueue time over the same calls",
    }] + [dict({
        "checked": True, "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/flash_attn_bwd.cu",
        "replaces": f"deeplearning4j_tpu/ops/flash_attention.py:{line}",
        "launches": fit_l[i] + fit_ln[f"k{i + 2}"]
        + sum(sd_counts(f"k{i + 2}").values())
        + sum(int8_counts("k4k5").values()),
        "launches_by_path": {"serve": 0, "train": 0, "bert_serve": 0,
                             "bert_fit": fit_l[i], **lstm_paths("k4k5"),
                             "bert_ln_fit": fit_ln[f"k{i + 2}"],
                             **sd_counts(f"k{i + 2}"),
                             **keras_counts("k4k5"),
                             **int8_counts("k4k5")},
        "fused_launches": fit_l[1] + fit_ln["bwd"]
        + sum(sd_counts("bwd").values()),
        "bert_bf16_fit": bf16_rows["bwd"],
        "max_abs_err": kbwd_attn["max_err"]["abs_float32"],
        "max_err_float32_of_max1_ref": kbwd_attn["max_err"]["float32"],
        "max_ulp_bfloat16": kbwd_attn["max_err"]["ulp_bfloat16"],
        "max_ulp_float16": kbwd_attn["max_err"]["ulp_float16"],
        "cases": kbwd_attn["cases"],
        "deterministic": True,
        "fit_step_ms": fitted["row"]["step_ms_median"],
        "fit_device_ms": fitted["row"]["device_ms"],
    }, **row) for i, line, row in ((2, 155, {
        "name": "K4 flash_attn_bwd (fused K4+K5)", "fused_with": "K5",
        "ms": per_step["ms"], "plain_ms": per_step["plain_ms"],
        "bound_ms": per_step["bound_ms"], "bound_by": tb32["bound_by"],
        "library_ms": per_step["library_ms"],
        "host_ms": per_step["host_ms"],
        "dq_only_ms": per_step["dq_only_ms"],
        "occupancy": tb32["occupancy"],
        "bfloat16": {k: tb16[k] for k in (
            "ms", "dq_only_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "occupancy")},
        "timed_as": bwd_timed_as}), (3, 184, {
        "name": "K5 flash_attn_bwd_dkv (inside K4's fused launch)",
        "fused_into": "K4",
        "ms": per_step["dkv_only_ms"], "plain_ms": per_step["plain_dkv_ms"],
        "bound_ms": per_step["bound_dkv_ms"],
        "bound_by": tb32["bound_dkv_by"],
        "library_ms": per_step["library_dkv_ms"],
        "bfloat16": {k: tb16[k] for k in (
            "dkv_only_ms", "plain_dkv_ms", "library_dkv_ms", "bound_dkv_ms",
            "bound_dkv_by")},
        "timed_as": dkv_timed_as}))] + [{
        "name": "K8 lstm_cell", "checked": True, "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/lstm_cell.cu",
        "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:55",
        "launches": served_lstm["serve_launches"]
        + served_lstm["stream_launches"] + sum(rnn_paths("k8").values())
        + sum(keras_counts("k8").values()) + sum(int8_counts("k8").values()),
        "launches_by_path": {"serve": 0, "train": 0, "bert_serve": 0,
                             "bert_fit": 0,
                             "lstm_serve": served_lstm["serve_launches"],
                             "lstm_stream": served_lstm["stream_launches"],
                             **rnn_paths("k8"), **no_gen, **no_ln,
                             **no_sd, **keras_counts("k8"),
                             **int8_counts("k8")},
        "max_abs_err": klstm["max_err"]["float32"],
        "max_abs_err_float32": klstm["max_err"]["float32"],
        "max_tolerance_share_bfloat16": klstm["max_err"]["ulp_bfloat16"],
        "max_tolerance_share_float16": klstm["max_err"]["ulp_float16"],
        "deterministic": True,
        "ms": ms8, "plain_ms": plain8, "bound_ms": bound8, "bound_by": by8,
        "library_ms": lib8, "host_ms": host8,
        "floor_ms": floor8,
        "by_shape": {str(sh): {"ms": klstm["times"][sh][0],
                               **klstm["shapes"][sh]}
                     for sh in LSTM_PATH_SHAPES},
        "cudnn_lstm_sequence_ms": served_lstm["cudnn_ms"],
        "keras_lstm_k8_per_request": KERAS_LSTM_K8,
        "lstm_rel_err_vs_cpu": served_lstm["rel_err"],
        "lstm_streams_rel_err_vs_cpu": served_lstm["rel_err_streams"],
        "lstm_stream_err": served_lstm["stream_err"],
        "lstm_fit": {k: fit_lstm["row"][k] for k in (
            "batch", "seq_len", "tbptt_length", "step_wall_ms_median",
            "characters_per_s", "device_ms", "device_busy_share",
            "device_kernels_per_step")},
        "lstm_fit_parity": {k: fit_lstm[k] for k in (
            "loss_rel_err", "grad_worst_ratio", "full_bptt_min_rel",
            "output_rel_err")},
        "timed_as": "device time of one float32 call at each of "
                    "TextGenerationLSTM's two layers at batch 32 ((32, 77, "
                    "256) and (32, 256, 256), row-strided x) times the 256 "
                    "steps of one batch-32 request; library_ms is "
                    "torch.lstm_cell on the same operands reordered to its "
                    "gate order; host_ms is the wrapper's enqueue time over "
                    "the same calls; floor_ms is an empty kernel launched "
                    "with K8's grid, cluster and shared memory, timed the "
                    "same way",
    }, {
        "name": "K9 decode_attn", "checked": True, "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/decode_attn.cu",
        "replaces": "deeplearning4j_tpu/ops/flash_attention.py:576",
        "launches": sum(k9_gen.values()) + sum(int8_counts("k9").values()),
        "launches_by_path": {"serve": 0, "train": 0, "bert_serve": 0,
                             "bert_fit": 0, "lstm_serve": 0,
                             "lstm_stream": 0, **rnn_paths("k9"), **k9_gen,
                             **no_ln, **no_sd, **keras_counts("k9"),
                             **int8_counts("k9")},
        "int8_generate": {"bench": {k: int8_gen["rows"]["bench"][k] for k in (
            "tokens_per_s", "ttft_ms_p50", "tpot_ms_p50", "device_ms",
            "device_busy_share")},
            "rel_err_vs_f32_recompute":
            int8_gen["walk"]["rel_err_vs_recompute"],
            "cache_bytes_int8_f32": list(int8_gen["cache_bytes"])},
        "launches_per_decode_step": GEN_LAYERS,
        "decode_steps_by_path": {
            "generate": rows["bench"]["decode_steps"],
            "generate_grow": rows["grow"]["decode_steps"]},
        "max_abs_err": kdec["max_err"]["float32"],
        "max_abs_err_float32": kdec["max_err"]["float32"],
        "max_tolerance_share_bfloat16": kdec["max_err"]["tol_share_bfloat16"],
        "max_tolerance_share_float16": kdec["max_err"]["tol_share_float16"],
        "deterministic": True,
        "ms": ms9, "plain_ms": plain9, "bound_ms": bound9, "bound_by": by9,
        "library_ms": lib9, "host_ms": host9, "floor_ms": floor9,
        "kernels_per_call_by_splits": kdec["per_split"],
        "long_cache": {"shape": list(DECODE_LONG_SHAPE), "ms": t9l[0],
                       "plain_ms": t9l[1], "library_ms": t9l[2],
                       "bound_ms": t9l[4], "bound_by": t9l[5],
                       "floor_ms": kdec["floors"][DECODE_LONG_SHAPE]},
        "generate": {tag: {k: r[k] for k in (
            "tokens_per_s", "wall_ms_median", "ttft_ms_p50", "ttft_ms_p99",
            "tpot_ms_p50", "tpot_ms_p99", "device_ms", "device_busy_share",
            "k9_device_ms", "k3_device_ms", "decode_steps_per_run")}
            for tag, r in rows.items()},
        "output_rel_err_vs_cpu": gen["output_rel_err"],
        "disagg": {k: disagg[k] for k in (
            "ttft_ms_p50", "ttft_ms_p99",
            "ttft_p99_ratio_colocated_over_split", "ttft_p99_ratios",
            "tpot_ms_p50", "shipments", "bytes_per_shipment",
            "wire_mb_per_s", "export_ms_p50", "import_ms_p50", "profiled")},
        "disagg_router": {k: disagg["router"][k] for k in (
            "passes", "pages_shipped")},
        "sd_decode_rel_err": sd_dec["rel_err"],
        "bfloat16_drop_split_check": dict(shape=list(DECODE_LONG_SHAPE),
                                          **kdec["power"]),
        "timed_as": "device time of one float32 call at the generative "
                    "path's shape (B=8, H=4, C=128, d=64, head-split q, the "
                    "lengths of a decode step halfway through the bench's "
                    "mix) times the 3 calls of one decode step; library_ms "
                    "is torch.nn.functional.scaled_dot_product_attention "
                    "with the float [B, 1, 1, C] length mask on the same "
                    "q, k, v; host_ms is the wrapper's enqueue time over "
                    "the same calls; floor_ms is an empty kernel launched "
                    "with K9's grid, threads and cluster, timed the same "
                    "way",
    }, {
        "name": "K10 mq_decode_attn", "checked": True, "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/mq_decode_attn.cu",
        "replaces": "deeplearning4j_tpu/ops/flash_attention.py:220",
        "launches": sum(k10_gen.values()) + sum(int8_counts("k10").values()),
        "launches_by_path": {"serve": 0, "train": 0, "bert_serve": 0,
                             "bert_fit": 0, "lstm_serve": 0,
                             "lstm_stream": 0, **rnn_paths("k10"), **k10_gen,
                             **no_ln, **no_sd, **keras_counts("k10"),
                             **int8_counts("k10")},
        "int8_generate_spec": {k: int8_gen["rows"]["spec"][k] for k in (
            "tokens_per_s", "ttft_ms_p50", "tpot_ms_p50", "verify_steps",
            "device_ms", "device_busy_share")},
        "launches_per_verify_step": GEN_LAYERS,
        "verify_steps_by_path": {
            "generate_spec": srows["spec"]["verify_steps"]
            + srows["spec_other_draft"]["verify_steps"],
            "generate_spec_grow": srows["spec_grow"]["verify_steps"]},
        "max_abs_err": kmq["max_err"]["float32"],
        "max_abs_err_float32": kmq["max_err"]["float32"],
        "max_tolerance_share_bfloat16": kmq["max_err"]["tol_share_bfloat16"],
        "max_tolerance_share_float16": kmq["max_err"]["tol_share_float16"],
        "deterministic": True,
        "ms": ms10, "plain_ms": plain10, "bound_ms": bound10,
        "bound_by": by10, "library_ms": lib10, "host_ms": host10,
        "floor_ms": floor10,
        "kernels_per_call_by_splits": kmq["per_split"],
        "grow_cache": {"shape": list(MQ_GROW_SHAPE), "ms": t10g[0],
                       "plain_ms": t10g[1], "library_ms": t10g[2],
                       "bound_ms": t10g[4], "bound_by": t10g[5],
                       "floor_ms": kmq["floors"][MQ_GROW_SHAPE]},
        "long_cache": {"shape": list(MQ_LONG_SHAPE), "ms": t10l[0],
                       "plain_ms": t10l[1], "library_ms": t10l[2],
                       "bound_ms": t10l[4], "bound_by": t10l[5],
                       "floor_ms": kmq["floors"][MQ_LONG_SHAPE]},
        "generate": {tag: {k: r[k] for k in (
            "tokens_per_s", "wall_ms_median", "ttft_ms_p50", "ttft_ms_p99",
            "tpot_ms_p50", "tpot_ms_p99", "device_ms", "device_busy_share",
            "k9_device_ms", "k10_device_ms", "k3_device_ms",
            "verify_steps_per_run", "draft_steps_per_run",
            "decode_steps_per_run", "speculative", "page_pool")}
            for tag, r in [("paged", paged["row"])] + list(srows.items())},
        "sd_decode_window_rel_err": sd_dec["rel_err"]["window"],
        "bfloat16_drop_split_check": dict(shape=list(MQ_LONG_SHAPE),
                                          **kmq["power"]),
        "timed_as": "device time of one float32 call at the speculative "
                    "mix's shape (B=8, H=4, k=4, C=128, d=64, head-split q, "
                    "the lengths of a verify step halfway through the mix) "
                    "times the 3 calls of one verify step; library_ms is "
                    "torch.nn.functional.scaled_dot_product_attention with "
                    "the float [B, 1, k, C] window mask on the same q, k, v; "
                    "host_ms is the wrapper's enqueue time over the same "
                    "calls; floor_ms is an empty kernel launched with "
                    "K10's grid, threads, cluster and shared memory, timed "
                    "the same way",
    }, {
        "name": "K6 layer_norm_act", "checked": True, "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/layer_norm_act.cu",
        "replaces": "deeplearning4j_tpu/ops/fused_epilogues.py:215",
        "launches": ln_l["k6"] + fit_ln["k6"] + sum(sd_counts("k6").values())
        + sum(int8_counts("k6").values()),
        "launches_by_path": {**{k: 0 for k in kernel_paths},
                             **rnn_paths("k6"), **ln_paths("k6"),
                             **sd_counts("k6"), **keras_counts("k6"),
                             **int8_counts("k6")},
        "bert_bf16_fit": bf16_rows["k6"],
        "launches_per_forward": LN_SITES,
        "max_abs_err": kln["max_err"]["y_abs_float32"],
        "max_abs_err_float32": kln["max_err"]["y_abs_float32"],
        "max_tolerance_share": {k: kln["max_err"][k]
                                for k in ("y", "y_float32", "mu", "rstd")},
        "cases": kln["cases"],
        "one_pass_variance_min_share": min(
            v[1] for v in kln["offset"].values()),
        "offset_rows_max_share": max(v[0] for v in kln["offset"].values()),
        "deterministic": True,
        "ms": ms6, "plain_ms": plain6, "bound_ms": bound6, "bound_by": by6,
        "library_ms": lib6, "host_ms": host6,
        "library_max_abs_diff": kln["times"]["library_max_abs_diff"][0],
        "bert_ln": {str(n): {k: r[k] for k in (
            "wall_ms_median", "sequences_per_s", "device_ms",
            "device_busy_share", "k6_device_ms", "k1_device_ms",
            "k3_device_ms")} for n, r in bert_ln["rows"].items()},
        "bert_ln_rel_err_vs_cpu": bert_ln["rel_err"],
        "bert_ln_rel_err_vs_unfused": bert_ln["rel_err_unfused"],
        "bert_batch32_wall_ms_tf_vs_fused": bert_ln["ab"],
        "timed_as": "device time of one float32 call at BERT-base batch 32 "
                    "(rows 4096, C 768, identity, eps 1e-12) times the 25 "
                    "calls of one fused forward; library_ms is "
                    "torch.nn.functional.layer_norm on the same x, gamma "
                    "and beta times 25; host_ms is the wrapper's enqueue "
                    "time over the same calls",
    }, {
        "name": "K7 layer_norm_act_bwd", "checked": True, "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/layer_norm_act_bwd.cu",
        "replaces": "deeplearning4j_tpu/ops/fused_epilogues.py:231",
        "launches": fit_ln["k7"] + sum(sd_counts("k7").values())
        + sum(int8_counts("k7").values()),
        "launches_by_path": {**{k: 0 for k in kernel_paths},
                             **rnn_paths("k7"), **ln_paths("k7"),
                             **sd_counts("k7"), **keras_counts("k7"),
                             **int8_counts("k7")},
        "bert_bf16_fit": bf16_rows["k7"],
        "launches_per_step": LN_SITES,
        "max_abs_err": kln["max_err"]["dx_abs_float32"],
        "max_abs_err_dx_float32": kln["max_err"]["dx_abs_float32"],
        "max_tolerance_share": {k: kln["max_err"][k] for k in (
            "dx", "dx_float32", "dgamma", "dbeta")},
        "cases": kln["cases"],
        "deterministic": True,
        "ms": ms7, "plain_ms": plain7, "bound_ms": bound7, "bound_by": by7,
        "library_ms": lib7, "host_ms": host7,
        "floor_ms": LN_SITES * kln["times"]["bwd_float32"]["floor_ms"],
        "occupancy": kln["times"]["bwd_float32"]["occupancy"],
        "bfloat16": kln["times"]["bwd_bfloat16"],
        "kernels_per_call_by_ctas": kln["bwd_per_call"],
        "library_max_abs_diff": kln["times"]["library_max_abs_diff"][1],
        "bert_ln_fit": {k: bert_ln_fit["row"][k] for k in (
            "step_ms_median", "sequences_per_s", "device_ms",
            "device_busy_share", "k6_device_ms", "k7_device_ms",
            "k1_device_ms", "k2_device_ms", "k3_device_ms",
            "bwd_device_ms")},
        "bert_ln_fit_parity": {"loss_rel_err": bert_ln_fit["parity"][0],
                               "worst_grad_share": bert_ln_fit["parity"][1]},
        "dy_copies": bert_ln_fit["copies"][1],
        "timed_as": "device time of one float32 call at BERT-base batch 32 "
                    "(rows 4096, C 768, identity) times the 25 calls of one "
                    "fused fine-tune step; library_ms is "
                    "torch.ops.aten.native_layer_norm_backward fed the same "
                    "dy, x, mean, rstd, gamma and beta (dx, dgamma, dbeta) "
                    "times 25; host_ms is the wrapper's enqueue time over "
                    "the same calls",
    }]}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
