#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one
CUDA card.

    python3 chip_smoke.py [--seed N] [--layers L]

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source of the port from ``finetune_controller_tpu_torch/
   csrc`` (one ``nvcc`` per source, in parallel) and check each kernel
   against its plain version at small shapes: the paged kernel in f32 and
   bf16, D 64/128/256, also at split edges (idx on and beside page and chunk
   boundaries, lanes shorter than one split beside full ones, S·G on both
   sides of the decode/prefill threshold, 1 to 7 splits), each launched
   twice for identical bits; the three flash kernels (T1) in f32 and bf16,
   D 64, 128 and 256, GQA groups 1 and 4, S 40/100/257, causal with segment ids
   and full attention with fully masked rows, with a non-zero lse
   cotangent, and at S=300 on the segment layouts of tile skipping (packed,
   16-token documents, boundaries on tile edges, non-monotonic ids,
   trailing padding); ptxas's register and spill report of every kernel;
   (Q0) ``quantize_int4`` of a seeded full-width Mixtral expert stack
   ``(8, 4096, 14336)`` on the card against the plain version on the CPU,
   bit for bit (packed bytes, scales and the dequantized stack), and
   ``int4_matmul``'s forward and ``grad_x`` at 1280 rows per expert against
   dequantize-then-``matmul`` (``INT4_REL_TOL``), timed;
3. build ``llama3-8b`` at full width (and full depth unless ``--layers``
   cuts it) in bf16 with random weights drawn on the card from ``--seed``;
4. serve 12 requests through ``Batcher`` -> ``BatchEngine`` -> the paged
   kernel with the service defaults (8 slots, buckets 32/128/512, 128 new
   tokens at most, 16-token pages, auto-sized pool, prefix cache on): more
   requests than slots, prompts of 20-500 tokens, four sharing a 300-token
   prefix (a copy-on-write page), 10 greedy and 2 sampled.  The paged
   kernel's launch count is zeroed just before this run and read just after;
5. check that all 12 finished with the lengths asked for, that no decode
   step failed, and that the paged kernel was launched;
6. hold the paged kernel against its plain version on the card at the
   engine's shapes (decode B=8, S=1 over the pool and tables the run
   produced; prefill B=1, S=512; the suffix prefill after a prefix hit,
   B=1, S=128, idx=300), check that two launches give the same bits, and
   time kernel, plain version and the library yardstick (CUDA-graph
   replays, so the wrapper's host work is not timed; the kernel also back
   to back) beside the kernel's bound and its split count;
7. compare first-token logits of the model's paged prefill under
   ``FTC_PAGED_ATTN=kernel`` and ``FTC_PAGED_ATTN=gather``;
   (J, the engine) S1's requests (``J_NEW_TOKENS`` each) through fresh S1
   engines with ``FTC_TRANSFER_GUARD`` unset and ``raise`` in turns, driven
   on the main thread so each decode window arms the CUDA sync-debug
   mode: 0 trips, the same tokens, the signatures within the engine's
   budget; decode ms/step off and on; the sync-free sampler against
   ``torch.multinomial`` on the card;
8. (H1) write the base T2's trainer draws from ``--seed`` as an HF
   directory in the layout of the published Meta-Llama-3-8B repository
   (bf16 shards of at most 5 GB, ``model.safetensors.index.json``,
   ``config.json``), after printing the free space of the work directory's
   file system (and failing when the bf16 base and T2's f32 export do not
   fit); read it back onto the card through
   ``load_llama_params`` and hold it against the writer's tensors, bit for
   bit; print write and read seconds and GB/s;
   (T2) train ``llama3-8b`` at full width through ``train.cli.main`` from
   that directory (``model.weights_dir``): LoRA rank
   16 on all seven projections, bf16 base, batch 4 x 2048 tokens of packed
   random-text documents in 2 microbatches, evaluation every 3 steps on a
   second seeded file (2 batches), 6 steps, then 2 more resumed from the
   step-6 checkpoint with ``export_merged``.  The flash kernels' launch
   counts are zeroed just before and read just after; the metrics rows, the
   schedule, the eval rows, the LoRA ``B`` leaves, the checkpoints,
   ``done.txt``, ``adapter/`` (14 f32 tensors a layer, r 16, alpha 32),
   ``merged/`` (9 tensors a layer and 3), ``heartbeat.json``, ``events.jsonl``, the
   spans of ``trace/trainer.jsonl`` and the phase columns are checked, and
   the losses printed beside those of the same run from a random-init
   base at 32 layers.
   H1, T2, H2 and S2 run ``HF_LAYERS`` = 6 of the 32 layers: the run may
   write 45 GiB to its disk at most, which 32 layers' bf16 base, f32
   merged export and checkpoints (46.3 GiB) exceed, and phases C, Q, M, V,
   P, R, W, D and P4 need about 29 GB beside them; after each phase the script prints what
   it has written (``DiskTally``) and fails past 45 GiB;
   (H2) the exported adapter against the step-8 LoRA tensors (bit for
   bit), and the merged checkpoint reloaded into a bf16 model through
   ``load_pretrained_`` against ``load_serving_model(merge_lora=True)``:
   first-token logits within 1 % of max |logit|; export and reload timed;
9. (S2) serve what T2 trained, from its artifacts directory, the base
   coming from ``model.weights_dir`` through the loader: (a)
   ``load_serving_model(merge_lora=True)`` serves 4 requests; (b) the
   unmerged checkpoint split by ``strip_lora_for_multitenant`` into the base
   and tenant ``job`` (rank 16), beside a seeded rank-8 tenant ``r8`` padded
   to 16, in a fleet of 2 in-process replicas sharing the weights behind the
   router, host KV tier on and a device pool small enough that prefixes
   demote: 24 requests (8 per tenant and the base, 20-500 prompt tokens,
   three of each sharing one 300-token prefix) with replica r0 killed at its
   decode step 20.  Checked: every request exactly once, a failover and a
   respawn, tenants' first-token logits against one-tenant engines and the
   merged model (and ``r8`` away from the base), no prefix splice across
   namespaces and a hit within one, demotions and a restore hit whose greedy
   tokens equal the device-resident prefix's, the paged kernel launched
   (its count zeroed just before the fleet's traffic and read just after);
   timed: decode ms/step base-only and over 3 tenants (host clock, and the
   device time per step under ``torch.profiler``), demote and restore ms
   per page, failover recovery, peak memory; (c) the unpaged engine serves 4
   requests, each token checked against ``cached_generate``'s cached path;
10. (C) the control plane on the card: the port's HTTP server in this
    process (stdlib ``controller/web.py``, an ephemeral port, its own
    event-loop thread, state and objects under ``build/chip_smoke_ctrl``,
    the paged KV cache on).  A dev token's user uploads T2's seeded
    documents (``POST /datasets``) and submits ``llama3-8b-lora`` on the
    ``h100`` flavor as multipart (LoRA rank 16, batch 4 x 2048 in 2
    microbatches, 6 steps, one checkpoint, a profiler window over steps 3
    and 4), at full width and ``C_LAYERS`` = 8 of 32 layers (an operator
    plugin, for the run's time limit) from random weights drawn from the
    job's seed.  The fair-share scheduler admits it, the local backend
    runs ``python -m finetune_controller_tpu_torch.train.cli`` on the card,
    the monitor follows it to SUCCEEDED.  Checked: the statuses, 6 metrics
    rows with finite losses, the logs, the timeline, ``/trace`` without
    problems, and the job's ``profile/`` trace listing launches of the
    three ``wg::`` flash kernels.  The job is promoted and loaded, and 4
    greedy requests of 20-500 prompt tokens go to ``POST
    /jobs/{id}/generate``: their tokens must equal those of an in-process
    ``BatchEngine`` (the service's ``EngineConfig``) on the model the
    loader builds from the same promoted prefix, and the paged kernel's
    count (zeroed just before the requests) must rise.  (Q) On the same
    server and dataset, ``mistral-7b-qlora`` at ``QLORA_LAYERS`` = 8 of 32
    layers (``QLORA_PLUGIN``, for the run's time limit; the
    ``jax_qlora`` framework:
    an int4 base quantized at init from the job's seed, LoRA rank 16 on all
    seven projections, C's batch shape, 6 steps, no profiler window) runs
    to SUCCEEDED, is promoted and loads unmerged (``lora_merged: false``);
    4 greedy ``/generate`` requests equal an in-process ``BatchEngine`` on
    the loader's model, the paged kernel's count rising; printed: submit ->
    RUNNING and first row, the median step over steps 2-6, tokens/s,
    promote and load s, TTFT, generated tokens/s and the int4 base's bytes;
    (M) ``mixtral-8x7b`` with int4 experts (``MOE_SPEC``: no mesh, bf16
    frozen tensors, LoRA rank 16 on the attention projections, batch 4 x
    2048 in 2 microbatches, full width and ``MOE_LAYERS`` = 8 of 32 layers
    (the run's time limit), the preset's ``full``
    remat) through ``train.cli.main`` in a process of its own (this script
    with ``--phase-child M``, beside D and K, its flash launches counted
    there), 4 steps then 2 resumed; checked: finite ``loss`` and a finite
    positive ``moe_aux``,
    the LoRA ``B`` leaves moved, the flash kernels launched, ``done.txt``,
    an attention-only adapter, the int4 base drawn identically by both runs
    and a rebuild; then one more step under ``torch.profiler`` (experts'
    ``bmm``, dequantization, routing and dispatch, flash), and in f32 a
    greedy generation whose cached path matches the uncached oracle's
    logits at a dropless capacity; printed: ms/step and tokens/s (median of
    steps 2-4), peak memory, the int4 base's bytes;
    (V) LLaVA-1.5: (V2, on C's server right after Q) 32 rows, each a
    336x336x3 image as an NPY ``data:`` URI (neither decode nor resize
    needs PIL; whether PIL imports is printed) with a prompt and a
    completion, uploaded with ``POST /datasets``; ``llava-1.5-lora`` on
    ``h100`` at full width (CLIP ViT-L/14-336 with 23 of its 24 blocks
    run, the projector, the 7B decoder at ``LLAVA_LAYERS`` = 8 of its 32
    layers by an operator plugin, for the run's time limit; LoRA rank 16 on all
    seven projections and the projector trained; batch 4 x 1472 text tokens
    behind the 576-token image prefix, 2048 positions, in 2 microbatches; 6
    steps, a profiler window over steps 3-4; the API spec's f32 base from
    the job's seed).  Checked: QUEUED -> RUNNING -> SUCCEEDED, 6 finite
    metrics rows, the adapter keyed under ``language_model`` and
    ``projector.safetensors`` (4096, 1024) and (4096, 4096), promotion, and
    ``/generate`` answering the reference loader's multimodal refusal;
    the profile lists the three ``wg::`` flash kernels and the
    ``vision_tower`` and ``mm_projector`` ranges.  Printed: submit -> first
    row, the median step outside step 1 and the profiled steps, tokens/s,
    the job's peak card memory and the tower's and projector's shares of
    the device time.  After M: (V0) the three flash kernels at the
    decoder's shape (B=2, S=2048, H=Hkv=32, D=128, causal, no segment ids)
    against their plain versions, twice for the same bits, timed beside
    SDPA and the bound; (V1) an HF LLaVA directory in the layout of
    ``llava-hf/llava-1.5-7b-hf`` (f16, the CLIP tower whole with 24 layers
    and the post norm, ``LLAVA_HF_LAYERS`` = 1 decoder layer for the disk
    cap; ~1.6 GB) read onto the card through ``load_llava_params`` bit for
    bit, GB/s printed; (V3) ``generate_cli --image`` on V2's artifacts,
    cached and ``--oracle``, 8 greedy tokens that must be equal, the
    rebuilt base's digest equal to that of the job's trainer rebuilt from
    the seed, TTFT and tokens/s of ``cached_generate`` on the rebuilt model;
    (P) the preference plane: (P1, on C's server after V2) 64 seeded
    pre-tokenized ``{prompt_tokens, chosen_tokens, rejected_tokens}`` rows
    (most right-padded to 512, some truncated) uploaded with ``POST
    /datasets``, and ``llama3-8b-dpo`` on ``h100`` at full width and C's
    depth (the API spec's f32 base, LoRA rank 16, 8 pairs x 512 in 2
    microbatches, 6 steps, evaluation every 3 steps on 16 held-out rows,
    which an operator plugin names since the API has no held-out field, a
    profiler window over steps 3-4).  Checked: SUCCEEDED, 6 finite rows
    with ``reward_margin``, ``dpo_accuracy`` and their ``eval_`` twins,
    ``ftc_dpo_reward_margin`` on ``/metrics`` while the job runs, the
    adapter, and in the profile the forward launches of steps 3-4 less
    those in ``evaluate`` exceeding twice the dQ launches (the SFT ratio)
    by exactly the reference forward's 32 x 2 x 2; promoted, 4
    ``/generate`` requests through the paged kernel equal an in-process
    engine.  After it and R: (P0) the DPO loss, margins and LoRA gradients
    of 2 full-width layers on the first 8 pairs, flash kernels against plain
    (T3's bounds on the sequence logprobs and gradients, the loss within
    ``DPO_LOSS_F32_REL_TOL`` of the plain path in f32), the forward
    kernel's lse finite on the padded rows, and
    the three flash kernels timed at the DPO shape (B=16, S=512, H=32,
    Hkv=8, D=128) beside SDPA and the bound; (P2) a reward model
    (``task: reward``, ``PREF_LAYERS`` = 8 layers, bf16 base, 4 steps) through
    ``train.cli.main`` on the same rows: step-0 scores through the kernels
    equal the plain path's mean completion logprob, finite
    ``bt_accuracy``, ``reward_head.msgpack`` read back (``w`` of 128256),
    the job served by the loader with the head dropped; (P3) the in-process
    RLHF-lite loop (``task: rlhf``, 8 layers, 6 steps, a checkpoint every
    2, the actor's engine with 4 slots and 16 new tokens): at least 2 actor
    reloads, the learner's base digest unchanged, paged launches by the
    actor and flash launches by the learner (each zeroed before and read
    after); buffer depth, staleness, bootstrap pairs and actor tokens/s
    printed; (P4) the disaggregated rollout plane: P2's reward job served
    by one reward worker process (``ReplicaFleet`` in process mode with
    ``reward_spec``), then ``task: rlhf`` through ``train.cli.main`` with
    P3's spec, ``P4_WORKERS`` rollout worker processes scoring each round
    with that worker's ``reward_score`` RPC, ``P4_TOTAL_STEPS`` steps and a
    checkpoint every ``P4_CHECKPOINT_EVERY``; ``rollout-1`` SIGKILLed once
    its first round is in and before the first commit (the learner's step
    ``P4_CHECKPOINT_EVERY`` waits for its respawn's first round).  Checked: finite
    rows; the respawn streams again, no (worker, pair id) ingested twice,
    duplicates dropped and every replay token-equal to its original;
    ``rollout-0``'s pid unchanged and its policy at the last pushed version
    (two pushes at least); a ``rollout.round`` span overlapping a learner
    step; the pairs' rewards the RPC's (a round re-scored), no oracle pair;
    paged launches in each rollout worker, flash forward launches in the
    reward worker, all three flash kernels in the learner; at most
    ``P4_DISK_BYTES`` written.  Printed: spawn seconds, kill -> respawned
    and streaming, actor tokens/s per worker and in all beside P3's,
    learner ms/step beside P3's, ``reward_score`` ms a round, the rollout
    base's and a policy blob's bytes, each process's peak card memory;
    (A) after P1, a fresh server with ``serve_autoscale`` on (``A_ENV``)
    over C's state and object store (:func:`serve_tenant_phase`): C's
    promoted job loaded as a ``serve`` tenant of the one-H100 catalog; a
    burst of ``A_BURST`` requests grows the fleet by a workload that stays
    QUEUED; with 4 requests in flight (``A_INFLIGHT_NEW_TOKENS``) a
    normal-priority job of C's spec (``A_ARGS``) reclaims the card: the
    replica drains (the 4 finish with C's tokens), the job is admitted
    within ``A_ADMIT_AFTER_DRAIN_S`` and trains on the flash kernels (its
    ``events.jsonl``); ``/generate`` answers 503 while no replica is up
    and through the paged kernel after the job; printed: the drain's
    seconds, drain -> admitted, SUCCEEDED -> serving again, requests lost
    (0), the card's used memory at each edge;
    (R) resilience after P1, on a server of its own whose retry supervisor
    may resubmit once (the backend restarts nothing): ``llama3-8b-lora`` at
    full width and C's depth with C's arguments, dataset and seed, a checkpoint
    every 2 steps and no profiler window, submitted by ``python -m
    finetune_controller_tpu_torch.controller.ctl submit ... --watch`` in a
    subprocess, and SIGKILLed after step 3 by the trainer's chaos hook
    (``StepFault`` through the backend's ``extra_env``).  Checked: RUNNING
    -> RETRYING -> RUNNING -> SUCCEEDED, one ``infra`` attempt in
    ``attempt_history``, the resume from step 2 when step 2's async save
    committed before the kill, else a sweep of its staging and a start
    from step 0, 6 metrics rows, a manifest matching its state in every
    committed step, no staging left in the sandbox or the object store,
    every flash kernel launched by each attempt, each loss within ``RESILIENCE_LOSS_REL_TOL`` of C's, at most
    ``RESILIENCE_DISK_BYTES`` written; printed: submit -> first row, kill
    -> resumed first row, each save's host time and snapshot time (async
    steps 2 and 4, blocking step 6), its writer's commit time, and each
    async save's cost with the step it overlaps.  (R2) a 2-layer trainer
    in this process whose asynchronous step-4 save, read back, equals the
    live tensors after step 4, and the snapshot of C's adapter state timed
    into fresh pageable, fresh pinned and reused pinned host memory;
    (W) after R, on C's state and object store: (W1) a server with
    ``serve_transport=process`` and 2 replicas loads C's promoted job (one
    staging, two worker processes on the card, each rebuilding the merged
    model and decoding through the paged kernel); 8 ``/generate`` requests,
    C's 4 prompts among them, must equal C's answers and an in-process
    engine over the same staged prefix; each worker's paged launches (its
    count since warm-up, from its probe), spawn seconds, peak memory, the
    card's used memory, TTFT and tokens/s per worker are printed; the
    workers drain to exit 0.  Then a multi-tenant server (C's adapter as
    tenant #1, P1's loaded through the admin route onto both workers) whose
    worker r0 SIGKILLs itself at decode step ``W_KILL_AT_STEP``: 8 requests
    answered once each, a failover and a respawn, the respawned worker's
    adapters synced at spawn, tokens equal an in-process tenant engine,
    ``ftc_serve_transport_*`` counters above 0 on ``/metrics``.  (W2) a
    server with ``warm_workers=1`` prewarms a trainer process; C's job (3
    steps, one checkpoint) starts in it (the log names the warm pid and the
    card it applied before touching CUDA), launches 128 / 64 / 64 flash
    forward / dQ / dK-dV a step, and its submit -> first row is printed
    beside C's cold start; W writes at most ``W_DISK_BYTES``;
    (D) after W, the control plane's storage and streaming
    (:func:`storage_phase`): the port's ``statestore_main`` as a
    subprocess, an S3 endpoint in this script that verifies every SigV4
    signature, and the port's server on both (``state_backend=remote``,
    ``object_store_backend=s3``, auth on); T2's documents uploaded to S3;
    C's job (full width, ``D_LAYERS`` = 8 of 32 layers by an operator
    plugin, for the run's time limit; C's arguments) followed over a
    WebSocket opened right after the submit with the gate ``D_SEARCH``,
    and synced by ``storage_cli sync --until-done-file`` beside it as a
    pod's sidecar would: SUCCEEDED, the stream's ``waiting:`` lines and
    then the gated lines equal to the REST log from the gate on (a line
    for each step, closed after the job ended), a ``last_lines=20``
    stream, the sidecar's exit 0, both S3 prefixes equal to the sandbox
    byte for byte, ``storage_cli get`` of the dataset byte for byte, the
    three flash kernels in the job's profile; promoted from S3 and 4
    ``/generate`` requests equal to an in-process engine (the paged count
    zeroed just before must rise); the state service restarted on its
    file with the record and rows unchanged; ``monitor_main`` against the
    same service and S3 (``process="monitor"`` on its ``/metrics``, two
    ticks, exit 0 on SIGTERM); D writes at most ``D_DISK_BYTES``;
    (K) after D, on D's S3 endpoint and state service, the k8s backend
    (:func:`k8s_phase`): :class:`KubeEndpoint` serves the kube API in this
    script (the objects in the port's ``InMemoryKubeClient``, admitted by
    its ``kueue_tick`` under a quota of one ``nvidia.com/gpu``) and runs a
    one-node kubelet (each pod's containers as host processes, native
    sidecar semantics); the port's server with ``FTC_BACKEND=k8s`` and no
    monitor of its own, ``monitor_main`` as a process of its own from before
    the submit; ``llama3-8b-lora`` at full width and ``K_LAYERS`` = 8 of 32
    layers, 5 steps (``K_ARGS``), on T2's documents: the JobSet requests
    ``nvidia.com/gpu: 1``; a second job submitted meanwhile stays suspended
    and QUEUED, is the queue snapshot, and is cancelled while queued, its
    JobSet and ConfigMap gone; the daemon alone moves the live job RUNNING
    -> SUCCEEDED with its ``training_duration`` and deletes its JobSet; the
    WebSocket follow gives the trainer's log through the pod log and closes
    after the trainer exits; the S3 prefix equals the pod's artifacts byte
    for byte, ``done.txt`` included; the trainer's ``kernel_launches``
    events count each flash kernel; after promotion from S3, 2
    ``/generate`` answers equal an in-process engine, the paged count
    rising; printed: submit -> admitted and -> first WebSocket line, the
    median step, the sidecar's SIGTERM -> exit, Completed -> SUCCEEDED, K's
    writes (at most ``K_DISK_BYTES``) and the card;
    (G) after K, Gemma's head dim 256 (:func:`gemma_phase`): the three flash
    kernels against their plain versions at Gemma-7B's (H = Hkv = 16) and
    Gemma-2B's (H = 8, Hkv = 1) heads, B=2, S=2048, bf16 and f32, with and
    without segment ids; their times at Gemma-7B's heads beside the plain
    version, SDPA and the bound; the shipped ``gemma-7b-lora`` submitted by
    its ``model_name`` (full width, ``G_LAYERS`` = 8 of 28 layers, the
    example's 8 x 512 batch, 5 steps): SUCCEEDED with finite losses, its
    trainer's ``kernel_launches`` holding ``G_FLASH_PER_STEP`` a step of
    each flash kernel, then promoted and one ``/generate`` equal to an
    in-process engine through the paged kernel at D = 256;
    (N) after K, ``N_BYTES`` of seeded chat and SFT rows (``DiskTally``
    counts them) packed into 2048-token blocks by the native packer, timed
    here, and by the Python loader in a subprocess beside the phases that
    follow, joined after F: the arrays bit-equal (SHA-256), both MB/s; T2
    must have taken the native path (``native_loader.packs_total``), and
    C's job must log it;
    (O) the JAX package's orbax checkpoint of ``tests/fixtures/
    jax_orbax_tiny`` restored through ``train/ocdbt.py`` with the native
    zstd decoder and its ``tiny-test`` job resumed on the card to the JAX
    package's recorded losses (``O_LOSS_RTOL``); the decoder timed over the
    fixture's largest frame (MB/s);
11. (T3) one loss and the LoRA gradients of a 2-layer, full-width model on
    a packed microbatch of the run, ``FTC_FLASH_ATTN=kernel`` against
    ``plain``, with a ``torch.profiler`` breakdown of the kernel step;
    (T5) the same 2 layers once under each remat policy (``none``,
    ``full``, ``mlp``, ``attn``, ``mlp_qkv``, ``flash``, ``mlp_flash``,
    ``wide``, ``matmuls``): loss and gradients against ``none``'s within
    T3's bounds, the flash forward launches of the step equal to
    ``REMAT_FLASH_FORWARDS`` per layer (zeroed before each policy's step,
    read after it, and summed over the policies for the ``kernels``
    line), ms/step and memory printed;
    (J, the trainer) ``J_STEPS`` steps of the same 2 layers through
    ``Trainer.step`` under ``transfer_guard="raise"`` and
    ``recompile_budget=2`` with no prefetch thread (the CUDA sync-debug
    mode armed): 0 trips, one signature, flash launches counted; then
    ``FTC_FAULT_TRANSFER=1``: the guard's host copy aborts step 2 with the
    sync-debug mode's error;
12. (T4) each flash kernel at the main path's shapes (B=2, S=2048, H=32,
    Hkv=8, D=128, bf16, the packed microbatch's segment ids): kernel, plain
    and library times beside the bound, the error against the plain
    version, the share of tile pairs it executes (``live_tiles`` at its tile
    sizes), its rate on that executed work and its share of the bound, each
    with no segment ids too (every causal tile pair), beside its time before
    the Hopper redesign; each launched twice must give the same bits;
    (B) ``ops/kernel_bench.py`` at T2's flash shape (forward and gradient,
    1 and 4 documents a row) and the paged decode shape, chained calls on
    the host clock, beside T4's CUDA events and S1's graph replay, SDPA a
    yardstick; the ``auto`` gate holds the kernel at every length;
13. (F) the fidelity proof at the reference's default scale
    (``fidelity.py:286-299``), on the card through the port's controller
    (``fidelity.run_proof``): ``pretrain_base`` (``tiny-test``, 600 steps
    on a 400 KB stdlib corpus, batch 16 x 128, exported as an HF
    directory), a LoRA SFT job (rank 8, lr 3e-3, 120 steps) from it
    submitted with ``task_builder`` to the local backend, whose subprocess
    trainer is ``train/cli.py``, and ``generate_cli`` on the job's synced
    artifacts with a held-out prompt; the
    reference's three checks (step-1 loss < 0.75 x random-init loss, final
    < 0.75 x step 1, the generation starts with ``SFT_PREFIX`` only after
    the job).  ``tiny-test`` runs the plain attention by its config (head
    dim 16, ``attention_impl="xla"``); the kernels are held on the
    full-width phases.  F runs in a process of its own (this script with
    ``--phase-child F``), started before H1 and joined after B, beside the
    phases between;
14. print the ``kernels`` (the four TPU kernels' ports, and the three
    flash kernels at D = 256 as ``*_d256``), ``serve``, ``serve_tenants``,
    ``control``, ``qlora``, ``moe``, ``llava``, ``prefs``, ``hf_io``,
    ``fidelity``, ``resilience``, ``workers``, ``storage``, ``k8s``,
    ``gemma``, ``orbax``, ``serve_tenant``, ``guards``, ``native_packer``,
    ``kernel_bench``, ``remat`` and ``train`` lines, the card line, and last
    ``{"ok": true, "device": {...}}``.

After each phase the script prints the phase's seconds and the run's
clock, and one line to standard error; at ``RUN_DEADLINE_S`` a watchdog
prints every thread's stack to standard error, kills the processes the run
started and exits 1.

Needs one card; exits non-zero where ``torch.cuda.is_available()`` is false
or the port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import asyncio
import atexit
import contextlib
import faulthandler
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
#: first-token logits, kernel vs gather engine path: max |diff| over the
#: largest |logit| (bf16 activations through every layer; see PERF.md)
LOGITS_REL_TOL = 0.05
#: each kernel's time before its Hopper redesign, in ms at the shapes this
#: script times it (PERF.md §6: the flash kernels on mma.sync, the paged
#: kernel on the CUDA cores with one block per (KV head, lane)), printed
#: beside the new time
EARLIER_MS = {"flash_forward": 0.733, "flash_backward_dq": 1.066, "flash_backward_dkv": 1.997,
              "paged decode": 0.0656, "paged prefill": 0.3408}


#: the most a run may write to the card machine's disk (deleted files count)
DISK_CAP_BYTES = 45 * 2**30
#: the run's clock: a card machine stops the run at 1200 s.  At this many
#: seconds the watchdog prints every thread's stack to standard error and
#: exits non-zero, so a run that is too slow or stuck says where it was
RUN_DEADLINE_S = 1180.0
RUN_T0 = time.perf_counter()
#: where the run's processes keep the bytecode they compile.  The card
#: machine's Python finds no bytecode it can use beside torch's, numpy's and
#: sympy's sources, so each process it starts compiles them again: seconds
#: of every job's and worker's start.  Here the first process to import a
#: module compiles it for all the others
PYCACHE_DIR = Path(__file__).resolve().parent / "build" / "pycache"


def share_bytecode() -> None:
    """Point this process, and every process it starts, at ``PYCACHE_DIR``."""
    PYCACHE_DIR.mkdir(parents=True, exist_ok=True)
    os.environ["PYTHONPYCACHEPREFIX"] = str(PYCACHE_DIR)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = str(PYCACHE_DIR)
    sys.dont_write_bytecode = False


class DiskTally:
    """What the run has written to the disk of the checkout, printed after
    each phase with the phase's share; past ``DISK_CAP_BYTES`` the run
    fails.  Two lower bounds are kept, and the larger one counts: the bytes
    this process and its reaped children have passed to ``write()``
    (``wchar`` of ``/proc/self/io``, deleted files included, but not the
    kernel-side copies of ``shutil.copyfile``), and the growth of the file
    system's used space (every copy, but not the files deleted since).
    (``write_bytes``, the bytes sent to a block device, reads 0 on the card
    machine's file system.)"""

    def __init__(self, root: Path = Path(__file__).resolve().parent):
        self.root = root
        self.start = self.last = self.read()
        self.last_clock = 0.0

    def read(self) -> tuple[int, int]:
        try:
            with open("/proc/self/io") as f:
                wchar = next(int(line.split()[1]) for line in f if line.startswith("wchar"))
        except (OSError, StopIteration, ValueError):
            wchar = 0
        return wchar, shutil.disk_usage(self.root).used

    def written(self, since=None) -> int:
        now, since = self.read(), since or self.start
        return max(now[0] - since[0], now[1] - since[1])

    def mark(self, phase: str) -> int:
        now = self.read()
        total = self.written()
        clock = time.perf_counter() - RUN_T0
        log(f"disk: {phase} wrote {self.written(self.last) / 1e9:.2f} GB; {total / 1e9:.2f} GB "
            f"({total / 2**30:.2f} GiB) since the start (write() calls "
            f"{(now[0] - self.start[0]) / 1e9:.2f} GB, used space "
            f"{(now[1] - self.start[1]) / 1e9:.2f} GB), cap {DISK_CAP_BYTES / 2**30:.0f} GiB")
        log(f"clock: {phase} took {clock - self.last_clock:.1f} s; {clock:.1f} s since the "
            f"start (deadline {RUN_DEADLINE_S:.0f} s)")
        print(f"chip_smoke: {phase} done at {clock:.1f} s ({clock - self.last_clock:.1f} s), "
              f"{total / 2**30:.2f} GiB written", file=sys.stderr, flush=True)
        self.last, self.last_clock = now, clock
        if total > DISK_CAP_BYTES:
            raise SmokeFailure(f"the run wrote {total / 2**30:.2f} GiB, past the "
                               f"{DISK_CAP_BYTES / 2**30:.0f} GiB cap")
        return total


DISK = DiskTally()


def _descendants(pid: int) -> list[int]:
    """Every live process below ``pid``, parents before their children
    (read from ``/proc``)."""
    children: dict[int, list[int]] = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        ppid = int(stat.rsplit(")", 1)[1].split()[1])
        children.setdefault(ppid, []).append(int(entry))
    out, todo = [], [pid]
    while todo:
        kids = children.get(todo.pop(), [])
        out += kids
        todo += kids
    return out


def start_watchdog() -> None:
    """At ``RUN_DEADLINE_S`` on the run's clock: print every thread's stack
    to standard error, SIGKILL every process this run started and exit 1.
    ``faulthandler``'s own timer, which needs no GIL, does the printing and
    the exit 12 s later should the Python thread not get to run."""
    import signal
    import threading

    left = RUN_DEADLINE_S - (time.perf_counter() - RUN_T0)

    def expire() -> None:
        print(f"chip_smoke: FAILED: the run passed its {RUN_DEADLINE_S:.0f} s deadline; "
              f"every thread's stack follows", file=sys.stderr, flush=True)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        for pid in _descendants(os.getpid())[::-1]:
            with contextlib.suppress(OSError):
                os.kill(pid, signal.SIGKILL)
        sys.stderr.flush()
        os._exit(1)

    timer = threading.Timer(left, expire)
    timer.daemon = True
    timer.start()
    faulthandler.dump_traceback_later(left + 12, exit=True)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def kernel_label(mangled: str) -> str:
    """``paged_attention_tc<128, true>`` from a mangled kernel name: the
    first name of the port's kernels in it, with its template arguments
    (numbers, ``true``/``false``, ``float``, class names)."""
    import re

    for m in re.finditer(r"(\d+)([A-Za-z_])", mangled):
        start, digits = m.start(2), m.group(1)
        for cut in range(len(digits)):  # "_116flash..." is "_1" then 16 letters
            n = int(digits[cut:])
            ident, rest = mangled[start:start + n], mangled[start + n:]
            if len(ident) == n and rest[:1] in ("I", "E", "v", "") \
                    and ident.startswith(("flash_", "paged_")):
                return ident + template_args(rest)
    return mangled


def template_args(rest: str) -> str:
    """``<128, true>`` from the mangled ``ILi128ELb1EE...`` after a name."""
    import re

    if not rest.startswith("I"):
        return ""
    args, i = [], 1
    while i < len(rest) and rest[i] != "E":
        if m := re.match(r"L([a-z])(\d+)E", rest[i:]):
            kind, value = m.groups()
            args.append({"1": "true", "0": "false"}[value] if kind == "b" else value)
        elif m := re.match(r"(\d+)", rest[i:]):  # a class name, length first
            n = int(m.group(1))
            args.append(rest[i + m.end():i + m.end() + n])
            i += n
        else:
            m = re.match(r".", rest[i:])
            args.append({"f": "float", "i": "int"}.get(m.group(0), m.group(0)))
        i += m.end()
    return "<" + ", ".join(args) + ">"


def make_requests(seed: int, vocab: int):
    """12 requests: 8 unrelated prompts of 20-500 tokens and 4 sharing a
    300-token prefix; max_new_tokens 16-128; the last two sampled."""
    from finetune_controller_tpu_torch.serve.engine import GenRequest

    rng = np.random.default_rng(seed)
    lens = [20, 47, 96, 130, 185, 260, 377, 500]
    prompts = [rng.integers(0, vocab, n).tolist() for n in lens]
    shared = rng.integers(0, vocab, 300).tolist()
    prompts += [shared + rng.integers(0, vocab, n).tolist() for n in (9, 44, 121, 199)]
    new = [16, 128, 40, 96, 64, 24, 128, 32, 80, 48, 128, 56]
    reqs = []
    for i, (p, n) in enumerate(zip(prompts, new)):
        sampled = i >= 10
        reqs.append(GenRequest(
            request_id=f"req{i:02d}", tokens=p, max_new_tokens=n,
            temperature=0.8 if sampled else 0.0, top_k=50 if sampled else 0,
            seed=seed + i,
        ))
    return reqs


def kernel_check_small() -> float:
    """First launches of the paged kernel: ``paged_check.check`` (random
    shapes and the split edges, f32 and bf16, each launched twice).
    Returns the worst bf16 error."""
    import torch
    from finetune_controller_tpu_torch.ops.kernels import paged_check

    return paged_check.check(torch.Generator(device="cuda").manual_seed(0))


FLASH_KERNELS = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")
#: each flash kernel's function name in ``csrc/flash_attention.cu``, as a
#: profiler trace names its launches
FLASH_KERNEL_SYMBOLS = {"flash_forward": "flash_fwd_wg", "flash_backward_dq": "flash_bwd_dq_wg",
                        "flash_backward_dkv": "flash_bwd_dkv_wg"}


def flash_inputs(gen, b, s, h, hkv, d, dtype, segments):
    """Random q, k, v, dO, lse cotangent and (B, S) segment ids on the card."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    seg = None
    if segments:  # documents of random length, as packing makes them
        starts = torch.rand((b, s), generator=gen, device="cuda") < 4.0 / s
        seg = torch.cumsum(starts.to(torch.int32), dim=1, dtype=torch.int32) + 1
    dlse = torch.randn((b, h, s), generator=gen, device="cuda")
    return rnd(b, s, h, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), rnd(b, s, h, d), dlse, seg


def flash_compare(q, k, v, dout, dlse, seg, kvseg, causal):
    """Each flash kernel against its plain version on the same inputs (the
    backward kernels take the plain forward's out and lse).  Returns
    {kernel: max abs err}; raises beyond ``TOLERANCE``."""
    import torch
    from finetune_controller_tpu_torch.ops.kernels import flash_attention as fa

    atol, rtol = fa.TOLERANCE[q.dtype]
    out_ref, lse_ref = fa.flash_forward_reference(q, k, v, seg, kvseg, causal)
    delta = fa.flash_delta(out_ref, dout, dlse)
    dq_ref, dk_ref, dv_ref = fa._backward_plain(q, k, v, dout, lse_ref, delta, seg, kvseg,
                                                causal)
    out, lse = fa.flash_forward(q, k, v, seg, kvseg, causal)
    dq = fa.flash_backward_dq(q, k, v, dout, lse_ref, delta, seg, kvseg, causal)
    dk, dv = fa.flash_backward_dkv(q, k, v, dout, lse_ref, delta, seg, kvseg, causal)
    torch.cuda.synchronize()
    errs = {}
    for kernel, pairs in (("flash_forward", ((out, out_ref), (lse, lse_ref))),
                          ("flash_backward_dq", ((dq, dq_ref),)),
                          ("flash_backward_dkv", ((dk, dk_ref), (dv, dv_ref)))):
        err = 0.0
        for got, want in pairs:
            got, want = got.float(), want.float()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{kernel}: output is not finite")
            err = max(err, (got - want).abs().max().item())
            if not torch.allclose(got, want, atol=atol, rtol=rtol):
                raise AssertionError(f"{kernel} vs plain at q {tuple(q.shape)} {q.dtype} "
                                     f"causal={causal} segments={seg is not None}: "
                                     f"max abs err {err} beyond {(atol, rtol)}")
        errs[kernel] = err
    return errs


def flash_check_small() -> dict:
    """First launches: each flash kernel against its plain version at small
    shapes — f32 and bf16, D 64, 128 and 256, groups 1 and 4, S 40/100/257,
    causal with segment ids and full attention with distinct key segments
    (so some rows are fully masked), with a lse cotangent; then causal at
    S=300 on each layout of ``flash_check.segment_layouts`` (packed,
    16-token documents, boundaries on tile edges, non-monotonic ids,
    trailing padding).  Returns the worst bf16 error of each kernel."""
    import torch
    from finetune_controller_tpu_torch.ops.kernels.flash_check import segment_layouts

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = dict.fromkeys(FLASH_KERNELS, 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128, 256):
            for group in (1, 4):
                for s in (40, 100, 257):
                    for causal in (True, False):
                        q, k, v, dout, dlse, seg = flash_inputs(gen, 2, s, 2 * group, 2, d,
                                                                dtype, segments=True)
                        kvseg = None
                        if not causal:  # the second half's keys match no query
                            pos = torch.arange(s, device="cuda")[None, :]
                            kvseg = torch.where(pos >= s // 2, seg + 1000, seg)
                        errs = flash_compare(q, k, v, dout, dlse, seg, kvseg, causal)
                        if dtype == torch.bfloat16:
                            for name, e in errs.items():
                                worst[name] = max(worst[name], e)
            for ids in segment_layouts(2, 300).values():
                q, k, v, dout, dlse, _ = flash_inputs(gen, 2, 300, 8, 2, d, dtype, segments=False)
                seg = torch.from_numpy(ids).cuda()
                errs = flash_compare(q, k, v, dout, dlse, seg, None, True)
                if dtype == torch.bfloat16:
                    for name, e in errs.items():
                        worst[name] = max(worst[name], e)
    return worst


def executed_pairs(seg, tile_q: int, tile_k: int, skips_segments: bool):
    """(query, key) pairs a causal kernel with these tiles computes on the
    segment ids ``seg`` — every pair of each tile pair ``live_tiles`` keeps,
    with the ids counted as one document when the kernel is given none
    (``skips_segments`` false) — and the share of causal tile pairs it
    keeps."""
    import torch
    from finetune_controller_tpu_torch.ops.kernels import flash_attention as fa

    s = seg.shape[1]
    one_doc = torch.zeros_like(seg)
    live = fa.live_tiles(seg if skips_segments else one_doc, None, tile_q, tile_k, True)
    causal = fa.live_tiles(one_doc, None, tile_q, tile_k, True)
    rows = torch.clamp(s - torch.arange(live.shape[1], device=seg.device) * tile_q, max=tile_q)
    cols = torch.clamp(s - torch.arange(live.shape[2], device=seg.device) * tile_k, max=tile_k)
    pairs = float((live * rows[None, :, None] * cols[None, None, :]).sum())
    return pairs, float(live.sum() / causal.sum())


#: operations per (query, key) pair of one head, over the head dim: the
#: forward's two products, dQ's three, dK/dV's four (2 operations each)
FLASH_OPS_PER_PAIR = {"flash_forward": 4, "flash_backward_dq": 6, "flash_backward_dkv": 8}


def flash_variants(q, k, v, dout, lse, delta, seg, library, lib_out, lib_dout) -> dict:
    """{kernel: (kernel call, plain call, library call)} on one set of
    inputs: ``library`` is the yardstick's forward call, and its backward
    (``lib_out`` under ``lib_dout``, dq, dk and dv at once) stands beside
    both backward kernels."""
    from finetune_controller_tpu_torch.ops.kernels import flash_attention as fa

    backward = lambda i: lib_out.backward(lib_dout, retain_graph=True)  # noqa: E731
    return {
        "flash_forward": (
            lambda i: fa.flash_forward(q, k, v, seg, None, True),
            lambda i: fa.flash_forward_reference(q, k, v, seg, None, True), library),
        "flash_backward_dq": (
            lambda i: fa.flash_backward_dq(q, k, v, dout, lse, delta, seg, None, True),
            lambda i: fa._backward_plain(q, k, v, dout, lse, delta, seg, None, True), backward),
        "flash_backward_dkv": (
            lambda i: fa.flash_backward_dkv(q, k, v, dout, lse, delta, seg, None, True),
            lambda i: fa._backward_plain(q, k, v, dout, lse, delta, seg, None, True), backward),
    }


def assert_flash_deterministic(q, k, v, dout, lse, delta, seg, tag: str) -> None:
    """The Hopper kernels are deterministic: a second launch gives the same
    bits."""
    import torch
    from finetune_controller_tpu_torch.ops.kernels import flash_attention as fa

    first, second = ((*fa.flash_forward(q, k, v, seg, None, True),
                      fa.flash_backward_dq(q, k, v, dout, lse, delta, seg, None, True),
                      *fa.flash_backward_dkv(q, k, v, dout, lse, delta, seg, None, True))
                     for _ in range(2))
    if not all(torch.equal(x, y) for x, y in zip(first, second)):
        raise AssertionError(f"{tag}flash forward / dQ / dK/dV: two launches differ")


def flash_bytes(q, k, seg) -> dict:
    """Bytes each flash kernel must move: each input read once, each output
    written once (q, k, v, dO, out, dq, dk, dv, segment ids, lse, delta)."""
    b, s, h, _ = q.shape
    item = q.element_size()
    io = (q.numel() * item, k.numel() * item, 0 if seg is None else seg.numel() * 4,
          b * h * s * 4)
    return {"flash_forward": 2 * io[0] + 2 * io[1] + io[2] + io[3],
            "flash_backward_dq": 3 * io[0] + 2 * io[1] + io[2] + 2 * io[3],
            "flash_backward_dkv": 2 * io[0] + 4 * io[1] + io[2] + 2 * io[3]}


def flash_bench(seg, reps: int, seed: int) -> dict:
    """The flash kernels at the main path's shapes (B=2, S=2048, H=32,
    Hkv=8, D=128, bf16, the packed batch's segment ids ``seg``): kernel,
    plain and library times (ms), the bound, the max error against the
    plain version, and the executed work (:func:`executed_pairs`) with its
    rate, per kernel.  Checks that the Hopper kernels give the same bits
    on two launches."""
    import torch
    import torch.nn.functional as F
    from finetune_controller_tpu_torch.ops.kernels import flash_attention as fa
    from finetune_controller_tpu_torch.ops.kernels.timing import cuda_time_ms

    b, s = seg.shape
    h, hkv, d = 32, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, dout, _, _ = flash_inputs(gen, b, s, h, hkv, d, torch.bfloat16, segments=False)
    errs = flash_compare(q, k, v, dout, None, seg, None, True)
    out, lse = fa.flash_forward_reference(q, k, v, seg, None, True)
    delta = fa.flash_delta(out, dout)

    # the library yardstick: SDPA over K/V repeated to all heads with a
    # causal-and-segment boolean mask; its backward computes dq, dk, dv at once
    pos = torch.arange(s, device="cuda")
    mask = (pos[:, None] >= pos[None, :])[None, None] & (seg[:, None, :, None] == seg[:, None, None, :])
    ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_() for x in
                  (q, k.repeat_interleave(h // hkv, 2), v.repeat_interleave(h // hkv, 2)))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
    lib_err = (lib_out.transpose(1, 2).float() - out.float()).abs().max().item()
    if lib_err > 0.1:
        raise AssertionError(f"library yardstick disagrees with plain by {lib_err}")
    variants = flash_variants(
        q, k, v, dout, lse, delta, seg,
        lambda i: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask),
        lib_out, dout.transpose(1, 2))
    assert_flash_deterministic(q, k, v, dout, lse, delta, seg, "")

    # the work this data needs: the live (query, key) pairs, causal and
    # within one document
    pairs = sum(float((c * (c + 1) / 2).sum()) for c in
                (torch.bincount(row).double() for row in seg.long()))
    nbytes = flash_bytes(q, k, seg)
    per_pair = {name: ops * h * d for name, ops in FLASH_OPS_PER_PAIR.items()}
    # what skipping saves: the Hopper kernels on the same inputs with no
    # segment ids, so every causal tile pair runs
    out_c, lse_c = fa.flash_forward_reference(q, k, v, None, None, True)
    delta_c = fa.flash_delta(out_c, dout)
    no_segments = {
        "flash_forward": lambda i: fa.flash_forward(q, k, v, None, None, True),
        "flash_backward_dq": lambda i: fa.flash_backward_dq(q, k, v, dout, lse_c, delta_c,
                                                            None, None, True),
        "flash_backward_dkv": lambda i: fa.flash_backward_dkv(q, k, v, dout, lse_c, delta_c,
                                                              None, None, True),
    }
    out_rows = {}
    for name, (kern, plain, lib) in variants.items():
        tq, tk = fa.TILES[d][name]
        executed, live_share = executed_pairs(seg, tq, tk, True)
        all_causal, _ = executed_pairs(seg, tq, tk, False)
        ms_all = cuda_time_ms(no_segments[name], reps)
        row = dict(ms_no_segments=ms_all,
                   tflops_no_segments=per_pair[name] * all_causal / (ms_all * 1e-3) / 1e12)
        ms = cuda_time_ms(kern, reps)
        plain_ms = cuda_time_ms(plain, max(2, reps // 4))
        library_ms = cuda_time_ms(lib, reps)
        flops = per_pair[name] * pairs
        bytes_ms = nbytes[name] / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / BF16_FLOPS * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        out_rows[name] = dict(
            row, ms=ms, plain_ms=plain_ms, library_ms=library_ms, max_abs_err=errs[name],
            bound_ms=bound_ms, bound_by="bytes" if bytes_ms >= flops_ms else "operations",
            bytes=int(nbytes[name]), flops=int(flops), executed_flops=int(per_pair[name] * executed),
            tflops=per_pair[name] * executed / (ms * 1e-3) / 1e12, bound_share=bound_ms / ms,
            live_tile_share=live_share, tiles=(tq, tk))
    return out_rows


def serve(engine, reqs):
    """Submit every request through the Batcher at once; returns results,
    the batcher, per-step (seconds, active lanes) and TTFTs (seconds)."""
    from finetune_controller_tpu_torch.serve.batcher import Batcher

    steps: list[tuple[float, int]] = []
    snapshots: list = []
    ttfts: list[float] = []
    orig_step = engine.step

    def timed_step():
        active = engine.active_requests
        if active:
            # the busiest step's tables/index feed the decode-shape check
            snapshots.append((int(engine._index.sum()), engine._tables.copy(),
                              engine._index.copy()))
        t0 = time.perf_counter()
        out = orig_step()  # ends in a device->host copy of the tokens
        steps.append((time.perf_counter() - t0, active))
        return out

    engine.step = timed_step

    async def go():
        batcher = Batcher(engine, max_queue=64, default_timeout_s=0,
                          ttft_observe=ttfts.append)
        try:
            results = await asyncio.gather(*(batcher.submit(r) for r in reqs))
        finally:
            await batcher.close()
        return results, batcher

    try:
        results, batcher = asyncio.run(go())
    finally:
        engine.step = orig_step
    busiest = max(snapshots, key=lambda s: s[0])
    return results, batcher, steps, ttfts, busiest


def attention_bench(kv, q, table, idx, reps):
    """Kernel / plain / library times (ms) cycling over every layer's pools,
    so the pools come from HBM as in the real step; max error vs plain, the
    split count, and a check that two launches give the same bits."""
    import torch
    import torch.nn.functional as F
    from finetune_controller_tpu_torch.ops.attention import paged_gather
    from finetune_controller_tpu_torch.ops.kernels.paged_attention import (
        TOLERANCE, paged_attention, paged_attention_reference, paged_splits,
    )
    from finetune_controller_tpu_torch.ops.kernels.timing import cuda_time_ms, graph_time_ms

    n_layers = kv.k.shape[0]
    b, s, h, d = q.shape
    hkv = kv.k.shape[3]
    cap = table.shape[1] * kv.k.shape[2]
    qpos = idx.long()[:, None] + torch.arange(s, device=q.device)[None, :]
    mask = (torch.arange(cap, device=q.device)[None, None, :] <= qpos[:, :, None])[:, None]

    def library(i):
        k = paged_gather(kv.k[i % n_layers], table).transpose(1, 2)
        v = paged_gather(kv.v[i % n_layers], table).transpose(1, 2)
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
        return F.scaled_dot_product_attention(q.transpose(1, 2), k, v, attn_mask=mask)

    atol, rtol = TOLERANCE[q.dtype]
    worst = 0.0
    for layer in (0, n_layers - 1):
        got = paged_attention(q, kv.k[layer], kv.v[layer], table, idx).float()
        want = paged_attention_reference(q, kv.k[layer], kv.v[layer], table, idx).float()
        lib = library(layer).transpose(1, 2)
        if not torch.isfinite(got).all():
            raise AssertionError("kernel output is not finite")
        worst = max(worst, (got - want).abs().max().item())
        if not torch.allclose(got, want, atol=atol, rtol=rtol):
            raise AssertionError(f"kernel vs plain beyond (atol, rtol) = {(atol, rtol)}: "
                                 f"max abs err {worst}")
        lib_err = (lib.float() - want.float()).abs().max().item()
        if lib_err > 0.1:
            raise AssertionError(f"library yardstick disagrees with plain by {lib_err}")
        if not torch.equal(got, paged_attention(q, kv.k[layer], kv.v[layer], table, idx).float()):
            raise AssertionError("two launches give different bits")
    splits = paged_splits(b, s, h, hkv, cap, q.dtype,
                          torch.cuda.get_device_properties(q.device).multi_processor_count)
    def kernel(i):
        return paged_attention(q, kv.k[i % n_layers], kv.v[i % n_layers], table, idx)

    def plain(i):
        return paged_attention_reference(q, kv.k[i % n_layers], kv.v[i % n_layers], table, idx)

    # device time of graph replays; back-to-back calls beside it (host work included)
    ms, plain_ms, library_ms = (graph_time_ms(fn, reps) for fn in (kernel, plain, library))
    eager_ms = cuda_time_ms(kernel, reps)
    # bound: each attended K/V row once, q and out once, table and index once
    rows = torch.clamp(idx.long() + s, max=cap).sum().item()
    item = kv.k.element_size()
    nbytes = (2 * rows * hkv * d * item + 2 * q.numel() * item
              + table.numel() * 4 + idx.numel() * 4)
    attended = sum(min(cap, int(i0) + j + 1) for i0 in idx.tolist() for j in range(s))
    flops = 4 * h * d * attended
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return dict(ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, library_ms=library_ms,
                max_abs_err=worst, splits=splits, bound_ms=max(bytes_ms, flops_ms),
                bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                bytes=int(nbytes), flops=int(flops))


def profile_decode(engine, reqs, steps: int = 4):
    """``torch.profiler`` over a few full-batch decode steps: wall time per
    step, device-busy share, and device time by kernel name.  The lanes are
    admitted (prefill) outside the window and evicted after it."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    for r in reqs[: engine.config.slots]:
        engine.admit(dataclasses.replace(r, request_id=f"prof-{r.request_id}",
                                         max_new_tokens=engine.config.max_new_tokens))
    engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        wall = time.perf_counter() - t0
    for r in reqs[: engine.config.slots]:
        engine.evict(f"prof-{r.request_id}")
    window = device_time_by_kernel(prof, wall, top=8)
    device_ms = window["device_ms"]
    return dict(
        step_ms=wall / steps * 1e3,
        device_ms_per_step=device_ms / steps if device_ms else None,
        device_busy=window["device_busy"],
        top=[(name, ms / steps) for name, ms in window["top"]],
    )


def logits_check(model, prompts, pool_pages, page_tokens):
    """First-token logits of a paged prefill with the kernel and with the
    plain gather path, on a fresh pool each; returns the worst relative
    error (max |diff| / max |logit|)."""
    import torch
    from finetune_controller_tpu_torch.models.llama import PagedKV

    worst = 0.0
    mp = pool_pages - 1
    table = torch.arange(1, pool_pages, dtype=torch.int32, device="cuda")[None, :]
    for prompt in prompts:
        bucket = 512
        tokens = torch.zeros((1, bucket), dtype=torch.long, device="cuda")
        tokens[0, :len(prompt)] = torch.tensor(prompt, device="cuda")
        positions = torch.arange(bucket, dtype=torch.int32, device="cuda")[None, :]
        idx = torch.zeros((1,), dtype=torch.int32, device="cuda")
        out = {}
        for impl in ("kernel", "gather"):
            os.environ["FTC_PAGED_ATTN"] = impl
            kv = PagedKV.zeros(model.cfg, pool_pages, page_tokens, "cuda")
            out[impl] = model.forward_paged(tokens, positions, kv, table[:, :mp], idx,
                                            last_idx=len(prompt) - 1).float()
        os.environ.pop("FTC_PAGED_ATTN")
        if not torch.isfinite(out["kernel"]).all():
            raise AssertionError("kernel-path logits are not finite")
        rel = ((out["kernel"] - out["gather"]).abs().max()
               / out["gather"].abs().max()).item()
        worst = max(worst, rel)
    return worst


class SmokeFailure(Exception):
    """A phase failed; the message says which and why."""


def serve_phase(args):
    """Phases 3-7: serve through the batcher, check the results, hold the
    paged kernel against its plain version at the engine's shapes, and
    compare kernel and gather logits.  Returns (kernels entry, serve
    summary); the model and the engine are freed when it returns."""
    import torch
    from finetune_controller_tpu_torch.models.llama import PRESETS, LlamaForCausalLM, init_random_
    from finetune_controller_tpu_torch.ops.kernels.paged_attention import (
        TOLERANCE, paged_attention,
    )
    from finetune_controller_tpu_torch.serve.engine import BatchEngine, EngineConfig, warm_engine

    cfg = PRESETS["llama3-8b"].replace(param_dtype=torch.bfloat16)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    t0 = time.perf_counter()
    model = init_random_(LlamaForCausalLM(cfg, device="cuda"), args.seed).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"llama3-8b: {cfg.n_layers} layers, {n_params / 1e9:.3f} B params bf16, "
        f"built in {time.perf_counter() - t0:.1f} s")

    ecfg = EngineConfig(slots=8, prompt_buckets=(32, 128, 512), max_new_tokens=128,
                        prefix_cache_bytes=512 << 20, page_tokens=16)
    engine = BatchEngine(model, ecfg)
    log(f"engine: pool {ecfg.effective_pool_pages} pages x {engine.kv.page_bytes} B, "
        f"{ecfg.pages_per_lane} pages per lane")
    t0 = time.perf_counter()
    warm_engine(engine)
    torch.cuda.synchronize()
    log(f"warm-up {time.perf_counter() - t0:.1f} s")
    reqs = make_requests(args.seed, cfg.vocab_size)
    paged_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        results, batcher, steps, ttfts, busiest = serve(engine, reqs)
    except Exception as e:  # any request failure fails the phase
        raise SmokeFailure(f"serving: {type(e).__name__}: {e}") from e
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    stats = batcher.stats()
    if len(results) != len(reqs):
        raise SmokeFailure(f"{len(results)} of {len(reqs)} requests finished")
    for req, res in zip(reqs, results):
        if res.request_id != req.request_id or len(res.generated) != req.max_new_tokens \
                or res.finish_reason != "length" \
                or not all(0 <= t < cfg.vocab_size for t in res.generated):
            raise SmokeFailure(f"bad result for {req.request_id}: {res.finish_reason}, "
                               f"{len(res.generated)} of {req.max_new_tokens} tokens")
    if stats["step_errors_total"] != 0:
        raise SmokeFailure(f"step_errors_total = {stats['step_errors_total']}")
    if launches <= 0:
        raise SmokeFailure("the paged-attention kernel was not launched on the main path")
    if engine.prefix_hits_total < 3 or stats["kv_cow_copies_total"] < 1:
        raise SmokeFailure(f"expected prefix hits and a copy-on-write page, got "
                           f"{engine.prefix_hits_total} hits, "
                           f"{stats['kv_cow_copies_total']} copies")
    decode_time = sum(dt for dt, _ in steps)
    decode_tokens = sum(active for _, active in steps)
    ttfts_ms = sorted(t * 1e3 for t in ttfts)
    log(f"served {len(results)} requests in {wall:.2f} s: {stats['tokens_generated_total']} "
        f"tokens, {len(steps)} decode steps, {launches} kernel launches, "
        f"{engine.prefix_hits_total} prefix hits, {stats['kv_cow_copies_total']} CoW copies, "
        f"peak memory {peak_gb:.2f} GB")
    log(f"decode: {decode_tokens / decode_time:.1f} tokens/s over {len(steps)} steps "
        f"({decode_time / len(steps) * 1e3:.2f} ms/step mean, up to 8 lanes)")
    log(f"time to first token (queue + prefill): p50 {ttfts_ms[len(ttfts_ms) // 2]:.1f} ms, "
        f"max {ttfts_ms[-1]:.1f} ms over {len(ttfts_ms)} requests")

    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    _, tables, index = busiest
    shapes = {}
    try:
        q = torch.randn((8, 1, cfg.n_heads, cfg.head_dim), generator=gen,
                        device="cuda").to(torch.bfloat16)
        shapes["decode"] = attention_bench(
            engine.kv, q, torch.from_numpy(tables).cuda(), torch.from_numpy(index).cuda(),
            args.reps)
        perm = torch.randperm(ecfg.effective_pool_pages - 1, generator=gen, device="cuda") + 1
        table = perm[: ecfg.pages_per_lane].to(torch.int32)[None, :]
        q = torch.randn((1, 512, cfg.n_heads, cfg.head_dim), generator=gen,
                        device="cuda").to(torch.bfloat16)
        shapes["prefill"] = attention_bench(
            engine.kv, q, table, torch.zeros((1,), dtype=torch.int32, device="cuda"),
            max(8, args.reps // 4))
        # the suffix after a hit on the shared 300-token prefix
        q = torch.randn((1, 128, cfg.n_heads, cfg.head_dim), generator=gen,
                        device="cuda").to(torch.bfloat16)
        shapes["suffix prefill"] = attention_bench(
            engine.kv, q, table, torch.full((1,), 300, dtype=torch.int32, device="cuda"),
            max(8, args.reps // 4))
    except (AssertionError, RuntimeError, ValueError) as e:
        raise SmokeFailure(f"kernel at engine shapes: {e}") from e
    for name, r in shapes.items():
        earlier = EARLIER_MS.get(f"paged {name}")
        log(f"paged_attention {name}: kernel {r['ms']:.4f} ms ("
            + (f"before the redesign {earlier} ms" if earlier else "no earlier time")
            + f"; {r['eager_ms']:.4f} ms back to back with the wrapper's host work), "
            f"{r['splits']} split(s), plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}: {r['bytes']} B, {r['flops']} FLOP), "
            f"max abs err {r['max_abs_err']:.4g} (tolerance {TOLERANCE[torch.bfloat16]}), "
            "two launches identical")

    prompts = [reqs[i].tokens for i in (0, 5, 7)]
    try:
        rel = logits_check(model, prompts, ecfg.pages_per_lane + 1, ecfg.page_tokens)
    except (AssertionError, RuntimeError, ValueError) as e:
        raise SmokeFailure(f"logits check: {e}") from e
    log(f"first-token logits, kernel vs gather: max |diff| / max |logit| = {rel:.4g} "
        f"(tolerance {LOGITS_REL_TOL})")
    if not rel <= LOGITS_REL_TOL:
        raise SmokeFailure("first-token logits differ beyond the tolerance")

    prof = profile_decode(engine, reqs)
    if prof["device_busy"] is None:
        log("decode profile: the profiler recorded no device time (not measured)")
    else:
        log(f"decode profile (8 lanes): {prof['step_ms']:.2f} ms/step wall, "
            f"{prof['device_ms_per_step']:.2f} ms/step device, "
            f"device busy {prof['device_busy']:.3f}")
        for name, ms in prof["top"]:
            log(f"  {ms:8.3f} ms/step  {name}")

    # J: the decode window under the transfer guard, on this model
    try:
        guards = guard_decode_phase(model, reqs)
    except (AssertionError, RuntimeError, ValueError) as e:
        raise SmokeFailure(f"J decode: {type(e).__name__}: {e}") from e
    log(f"J decode under FTC_TRANSFER_GUARD=raise (S1's {guards['requests']} requests, "
        f"{guards['new_tokens']} new tokens each, driven on the main thread, CUDA sync-debug "
        f"mode armed in each window): {guards['trips']} trips over {guards['windows']} "
        f"windows, tokens equal to the unguarded engine's, signatures {guards['signatures']} "
        f"within the budget {guards['budget']}; decode ms/step off "
        f"{[round(x, 2) for x in guards['decode_ms_per_step_off']]}, raise "
        f"{[round(x, 2) for x in guards['decode_ms_per_step_raise']]}; paged launches "
        f"{guards['paged_launches']}")

    dec = shapes["decode"]
    entry = {
        "name": "paged_attention",
        "route": "cuda",
        "source": "finetune_controller_tpu_torch/csrc/paged_attention.cu",
        "replaces": "finetune_controller_tpu/ops/pallas/paged_attention.py:65",
        "launches": launches + guards["paged_launches"],
        "launches_by_path": {"s1": launches, "j_decode": guards["paged_launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"], "library_ms": dec["library_ms"],
        "shapes": {name: {k: r[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms", "max_abs_err", "splits")}
                   for name, r in shapes.items()},
    }
    summary = {
        "requests": len(results), "tokens": stats["tokens_generated_total"],
        "decode_tokens_per_s": decode_tokens / decode_time,
        "decode_ms_per_step": decode_time / len(steps) * 1e3,
        "ttft_ms_p50": ttfts_ms[len(ttfts_ms) // 2], "ttft_ms_max": ttfts_ms[-1],
        "wall_s": wall, "peak_memory_gb": peak_gb, "layers": cfg.n_layers,
        "logits_rel_err": rel, "profile": prof, "guards_decode": guards,
    }
    return entry, summary


#: depth of the model H1 writes, T2 trains and H2 and S2 load: the run may
#: write 45 GiB to its disk at most, and at 32 layers H1's bf16 base (16.06
#: GB), T2's f32 merged export (32.12 GB) and T2's three checkpoints (1.51
#: GB) are 49.7 GB (46.3 GiB); each layer is 1.31 GB of bf16 base and f32
#: export.  At 18 layers the whole run, R included, wrote 44.13 GiB on an
#: H100 machine, and one job phase alone (Q) wrote 1.00 GB more than in the
#: run before (what the artifact sync catches of a save varies), so 18
#: layers can pass the cap; 16 layers left 3.3 GiB (41.68 GiB written), and
#: P4's rollout base (5.59 GB at 8 layers) needed more, so 12 (42.20 GiB
#: written); phase D's job on S3 writes about 2.5 GiB more, so 10 (40.46
#: GiB written with phases A, J, N and B); 6 for a run that must also end
#: inside 1200 s on the slower card machines
HF_LAYERS = 6
#: the llama3-8b preset's depth, which S1 serves
PRESETS_DEPTH = 32
#: LoRA SFT of llama3-8b (full width, ``HF_LAYERS`` deep) through the spec
#: CLI (phase T2)
TRAIN_SPEC = {
    "job_id": "chip-smoke-sft",
    "model": {"preset": "llama3-8b", "lora": {"rank": 16, "alpha": 32.0},
              "overrides": {"n_layers": HF_LAYERS}},
    "training": {"mode": "lora", "frozen_dtype": "bfloat16", "batch_size": 4, "seq_len": 2048,
                 "grad_accum_steps": 2, "total_steps": 6, "warmup_steps": 2,
                 "learning_rate": 2e-4, "log_every": 1, "checkpoint_every": 3,
                 "eval_every": 3, "eval_steps": 2, "heartbeat_interval_s": 0.01},
}
#: H1: the hub's shard size limit for the base written as an HF directory
HF_SHARD_BYTES = 5 * 10**9
#: H2: merged checkpoint reloaded in bf16 vs the loader's merge, first-token
#: logits, max |diff| / max |logit|
MERGED_REL_TOL = 0.01
#: F: the reference's default scale (``fidelity.py:286-299``)
FIDELITY = dict(pretrain_steps=600, corpus_bytes=400_000, batch_size=16, seq_len=128,
                lora_rank=8, sft_learning_rate=3e-3, sft_steps=120, max_new_tokens=24)
#: T2's 8 losses at 32 layers from the random-init base (seed 0), on an
#: NVIDIA H100 80GB HBM3 at 700 W before T2 read an HF directory; printed
#: beside this run's
RANDOM_INIT_T2_LOSSES = [12.108512878417969, 12.082706451416016, 11.533029556274414,
                         9.84800910949707, 9.645097732543945, 8.93314266204834,
                         8.015846252441406, 7.339583396911621]
#: T3, kernel vs plain flash path through 2 full-width layers in bf16:
#: |loss difference| / |loss| and, per LoRA leaf, max |grad difference| /
#: max |grad| (the two paths round p and ds to bf16 from f32 sums taken in
#: different orders; bf16 activations carry that through both layers)
MODEL_LOSS_REL_TOL = 5e-3
MODEL_GRAD_REL_TOL = 0.05
#: P0: |DPO loss through the kernels - the plain path's in f32| / the f32
#: loss (the plain path in bf16 is itself ~1.1e-2 off the f32 one)
DPO_LOSS_F32_REL_TOL = 5e-3


def write_documents(path, seed: int, n: int = 120) -> None:
    """``n`` random-text documents of 200-6000 bytes as {"text": ...} rows."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
    with open(path, "w") as f:
        for _ in range(n):
            size = int(rng.integers(200, 6001))
            chars = letters[rng.integers(0, 26, size)]
            chars[rng.random(size) < 0.17] = ord(" ")
            f.write(json.dumps({"text": chars.tobytes().decode()}) + "\n")


class _Capture:
    """Messages of one logger, kept while the CLI runs."""

    def __init__(self, name: str):
        import logging

        self.messages: list[str] = []
        self.times: list[float] = []
        self.logger = logging.getLogger(name)
        self.handler = logging.Handler()
        self.handler.emit = lambda record: (self.messages.append(record.getMessage()),
                                            self.times.append(record.created))

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def _rows(path) -> list[dict]:
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def train_phase(work, seed: int) -> dict:
    """T2: LoRA SFT of llama3-8b (full width, ``HF_LAYERS`` deep) through
    ``train.cli.main`` from H1's HF directory, evaluating every 3 steps on
    a held-out file, 6 steps, then 2 more resumed from the step-6
    checkpoint with ``export_merged``.  The flash kernels' counts are zeroed
    before the first run and read after the second."""
    import torch
    from finetune_controller_tpu_torch.obs.events import parse_event_lines
    from finetune_controller_tpu_torch.obs.phase import PhaseClock
    from finetune_controller_tpu_torch.obs.trace import parse_span_lines
    from finetune_controller_tpu_torch.models.safetensors_io import SafetensorsFile
    from finetune_controller_tpu_torch.ops.kernels import flash_attention as fa
    from finetune_controller_tpu_torch.resilience.heartbeat import read_heartbeat_file
    from finetune_controller_tpu_torch.train import cli
    from finetune_controller_tpu_torch.train.optimizer import build_schedule

    spec = t2_spec(work)
    spec["training"]["seed"] = seed
    n_layers = cli.build_model_config(spec).n_layers
    write_documents(spec["dataset"]["path"], seed)
    write_documents(spec["dataset"]["eval_path"], seed + 1, n=40)
    art = Path(spec["artifacts_dir"])
    spec_path = work / "job.json"
    for name in FLASH_KERNELS:
        getattr(fa, name).launches = 0
    walls, peaks = [], []
    with _Capture("finetune_controller_tpu_torch.train.trainer") as capture, \
            _Capture("finetune_controller_tpu_torch.models.hf_export") as exports:
        for total in (6, 8):
            spec["training"]["total_steps"] = total
            spec["training"]["export_merged"] = total == 8
            spec_path.write_text(json.dumps(spec))
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                rc = cli.main(["--spec", str(spec_path)] + DEVICE_ARGS)
            except Exception as e:
                raise SmokeFailure(f"training CLI ({total} steps): {type(e).__name__}: {e}") from e
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() / 1e9)
            if rc != 0:
                raise SmokeFailure(f"training CLI returned {rc}")
            gc.collect()
            torch.cuda.empty_cache()
            if total == 6:
                rows6 = _rows(art / "metrics.csv")
                state6 = torch.load(art / "checkpoints" / "step_6" / "state.pt",
                                    map_location="cpu", weights_only=True)
                for want in ("checkpoints/step_3", "checkpoints/step_6", "done.txt", "adapter"):
                    if not (art / want).exists():
                        raise SmokeFailure(f"the 6-step run left no {want}")
    launches = {name: getattr(fa, name).launches for name in FLASH_KERNELS}
    rows = _rows(art / "metrics.csv")
    # the merged export's time: from the adapter's log line to the merged one's
    marks = {m.split(" ")[1]: t for m, t in zip(exports.messages, exports.times)}
    export_s = marks["merged"] - marks["PEFT"]

    if len(rows6) != 6 or [int(r["step"]) for r in rows] != list(range(1, 9)):
        raise SmokeFailure(f"metrics.csv rows: {len(rows6)} after the first run, steps "
                           f"{[r['step'] for r in rows]} after the second")
    if not any("resumed from checkpoint step 6" in m for m in capture.messages):
        raise SmokeFailure("the second run did not resume from checkpoint step 6")
    tcfg = spec["training"]
    for total, chunk in ((6, rows[:6]), (8, rows[6:])):
        sched = build_schedule(tcfg["learning_rate"], tcfg["warmup_steps"], total)
        for r in chunk:
            step, loss, gnorm = int(r["step"]), float(r["loss"]), float(r["grad_norm"])
            if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0):
                raise SmokeFailure(f"step {step}: loss {loss}, grad_norm {gnorm}")
            if not math.isclose(float(r["learning_rate"]), sched(step - 1), rel_tol=1e-6,
                                abs_tol=1e-12):
                raise SmokeFailure(f"step {step}: learning_rate {r['learning_rate']} is not "
                                   f"the schedule's {sched(step - 1)}")
    moved = [k for k, v in state6["trainable"].items()
             if k.endswith(".lora_b") and v.abs().max().item() > 0]
    n_b = sum(k.endswith(".lora_b") for k in state6["trainable"])
    if len(moved) != n_b or n_b != n_layers * 7:
        raise SmokeFailure(f"{len(moved)} of {n_b} LoRA B leaves moved off zero")
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise SmokeFailure(f"flash kernels not launched on the main path: {missing}")
    # the artifacts: exports, eval rows, heartbeat, events, spans, phase columns
    adapter = SafetensorsFile(art / "adapter" / "adapter_model.safetensors")
    adapter_cfg = json.loads((art / "adapter" / "adapter_config.json").read_text())
    merged = SafetensorsFile(art / "merged" / "model.safetensors")
    n_f32 = sum(adapter.dtype(k) == torch.float32 for k in adapter.keys())
    n_adapter, n_merged = n_layers * 7 * 2, 3 + n_layers * 9  # 448 and 291 at 32 layers
    if (len(adapter.keys()), n_f32, adapter_cfg["r"], adapter_cfg["lora_alpha"]) != (
            n_adapter, n_adapter, 16, 32.0):
        raise SmokeFailure(f"T2: adapter/ holds {len(adapter.keys())} tensors ({n_f32} f32), "
                           f"r {adapter_cfg['r']}, alpha {adapter_cfg['lora_alpha']}")
    if len(merged.keys()) != n_merged or not (art / "merged" / "config.json").exists():
        raise SmokeFailure(f"T2: merged/ holds {len(merged.keys())} tensors")
    del adapter, merged
    eval_loss = {int(r["step"]): float(r["eval_loss"]) for r in rows if r.get("eval_loss")}
    if not all(math.isfinite(eval_loss.get(step, math.nan)) for step in (3, 6)):
        raise SmokeFailure(f"T2: eval_loss on the rows of steps 3 and 6: {eval_loss}")
    beat = read_heartbeat_file(str(art / "heartbeat.json")) or {}
    events = parse_event_lines((art / "events.jsonl").read_bytes())
    names = [e["event"] for e in events]
    committed = sorted(e["attrs"]["step"] for e in events if e["event"] == "checkpoint-committed")
    spans = {s["name"] for s in parse_span_lines((art / "trace" / "trainer.jsonl").read_bytes())}
    phase_columns = [c for c in PhaseClock.columns() if c not in rows[0]]
    if beat.get("step") != 8 or names.count("train-started") != 2 \
            or committed != [3, 6, 8] or "train-finished" not in names \
            or not {"fit", "init", "restore"} <= spans or phase_columns:
        raise SmokeFailure(f"T2: heartbeat {beat}, events {names} (committed {committed}), "
                           f"spans {sorted(spans)}, phase columns missing {phase_columns}")
    tokens = tcfg["batch_size"] * tcfg["seq_len"]
    step_ms = [tokens / float(r["tokens_per_sec"]) * 1e3 for r in rows]
    steady = sorted(step_ms[1:6] + step_ms[7:])
    losses = [float(r["loss"]) for r in rows]
    log(f"T2 ({n_layers} layers): losses {[round(x, 4) for x in losses]}; from the "
        f"random-init base at 32 layers {[round(x, 4) for x in RANDOM_INIT_T2_LOSSES]}; "
        f"eval_loss {eval_loss}; exports adapter/ "
        f"({n_adapter} f32 tensors, r 16, alpha 32) and merged/ ({n_merged} tensors); "
        f"heartbeat at step 8; "
        f"events {names}; spans {sorted(spans)}")
    return {
        "steps": len(rows), "layers": n_layers, "loss": losses,
        "random_init_32_layer_loss": RANDOM_INIT_T2_LOSSES,
        "eval_loss": eval_loss,
        "grad_norm": [float(r["grad_norm"]) for r in rows],
        "ms_per_step": step_ms, "ms_per_step_median": steady[len(steady) // 2],
        "tokens_per_s_median": tokens / (steady[len(steady) // 2] / 1e3),
        "phase_ms": {c: [float(r[c]) for r in rows] for c in PhaseClock.columns()},
        "peak_memory_gb": max(peaks), "wall_s": walls, "launches": launches,
        "lora_b_moved": len(moved), "export_s": export_s,
    }

def t2_spec(work) -> dict:
    """T2's job spec (``TRAIN_SPEC`` with the run's seed, data and dirs)."""
    spec = json.loads(json.dumps(TRAIN_SPEC))
    spec["model"]["weights_dir"] = str(work / "hf_base")
    spec["dataset"] = {"path": str(work / "train.jsonl"), "eval_path": str(work / "eval.jsonl")}
    spec["artifacts_dir"] = str(work / "artifacts")
    return spec


def hf_base_phase(work, seed: int) -> dict:
    """H1: the base T2's trainer draws from ``seed`` (the same spec, so the
    same generator draws), written as an HF directory in the layout of the
    published Meta-Llama-3-8B repository: bf16 shards of at most 5 GB, the
    index and ``config.json``.  Read back through ``load_llama_params`` onto
    the card and held against the writer's tensors, bit for bit."""
    import torch
    from finetune_controller_tpu_torch.models.hf_export import export_merged_checkpoint
    from finetune_controller_tpu_torch.models.hf_import import load_llama_params
    from finetune_controller_tpu_torch.models.llama import LlamaForCausalLM
    from finetune_controller_tpu_torch.models.lora import LoRAConfig
    from finetune_controller_tpu_torch.train import cli
    from finetune_controller_tpu_torch.train.trainer import Trainer

    spec = t2_spec(work)
    spec["training"]["seed"] = seed
    cfg = cli.build_model_config(spec)
    n_params = sum(p.numel() for p in LlamaForCausalLM(
        cfg.replace(lora=LoRAConfig()), device="meta").parameters())
    need = n_params * (2 + 4)  # H1's bf16 shards and T2's f32 merged export (read by H2)
    free = shutil.disk_usage(work).free
    log(f"H1, T2, H2, S2: {cfg.n_layers} of {PRESETS_DEPTH} layers, so that the base, the "
        f"merged export and the checkpoints stay under the run's 45 GiB of disk writes")
    log(f"H1: {free / 1e9:.1f} GB free on the file system of {work}; H1 and T2 write "
        f"{n_params * 2 / 1e9:.1f} GB (bf16) + {n_params * 4 / 1e9:.1f} GB (f32)")
    if free < need * 1.02:
        raise SmokeFailure(f"H1: {free / 1e9:.1f} GB free under {work}, the HF files need "
                           f"{need / 1e9:.1f} GB")
    trainer = Trainer(cfg, cli.build_train_config(spec), device=DEVICE)
    base = {k: v.detach() for k, v in trainer.model.state_dict().items()
            if not k.endswith((".lora_a", ".lora_b"))}
    out = Path(spec["model"]["weights_dir"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    export_merged_checkpoint(cfg, base, out, dtype=torch.bfloat16, max_shard_bytes=HF_SHARD_BYTES)
    write_s = time.perf_counter() - t0
    shards = sorted(out.glob("model-*-of-*.safetensors"))
    nbytes = sum(f.stat().st_size for f in shards)
    if not (out / "model.safetensors.index.json").exists() or not (out / "config.json").exists() \
            or max(f.stat().st_size for f in shards) > HF_SHARD_BYTES:
        raise SmokeFailure(f"H1: the HF directory is not in the hub's layout: {os.listdir(out)}")
    t0 = time.perf_counter()
    loaded = load_llama_params(out, cfg, dtype=torch.bfloat16, device=DEVICE)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    diff = sorted(set(base) ^ set(loaded)) + [k for k in base if k in loaded and not (
        loaded[k].dtype == base[k].dtype and torch.equal(loaded[k], base[k]))]
    if diff:
        raise SmokeFailure(f"H1: {len(diff)} tensors read back differ from the written ones, "
                           f"first {diff[:3]}")
    n_tensors = len(base)
    del trainer, base, loaded
    gc.collect()
    torch.cuda.empty_cache()
    summary = {"layers": cfg.n_layers, "of_layers": PRESETS_DEPTH,
               "layers_cut_for": "45 GiB of disk writes per run",
               "files": len(shards), "bytes": nbytes, "tensors": n_tensors, "write_s": write_s,
               "write_gb_per_s": nbytes / write_s / 1e9,
               "read_s": read_s, "read_gb_per_s": nbytes / read_s / 1e9,
               "free_gb": free / 1e9}
    log(f"H1: wrote the seeded {spec['model']['preset']} base as {len(shards)} bf16 shards "
        f"({nbytes / 1e9:.2f} GB) in {write_s:.1f} s ({summary['write_gb_per_s']:.2f} GB/s); "
        f"load_llama_params read it onto the card in {read_s:.1f} s "
        f"({summary['read_gb_per_s']:.2f} GB/s), every tensor bit-equal to the writer's")
    return summary


def merged_roundtrip_phase(art, export_s: float) -> dict:
    """H2: the adapter T2 exported against its step-8 checkpoint (bit for
    bit), and its merged checkpoint reloaded into a bf16 model through
    ``load_pretrained_`` against ``load_serving_model(merge_lora=True)``:
    first-token logits within ``MERGED_REL_TOL`` of max |logit|."""
    import torch
    from finetune_controller_tpu_torch.models.hf_import import load_pretrained_
    from finetune_controller_tpu_torch.models.llama import LlamaForCausalLM
    from finetune_controller_tpu_torch.models.lora import LoRAConfig
    from finetune_controller_tpu_torch.models.safetensors_io import SafetensorsFile
    from finetune_controller_tpu_torch.serve.loader import load_serving_model
    from finetune_controller_tpu_torch.train import cli

    state8 = torch.load(art / "checkpoints" / "step_8" / "state.pt", map_location="cpu",
                        weights_only=True)["trainable"]
    adapter = SafetensorsFile(art / "adapter" / "adapter_model.safetensors")
    prefix = "base_model.model.model.layers."
    bad = []
    for name in adapter.keys():
        i, module, proj, leaf = name[len(prefix):].split(".")[:4]
        group = "attn" if module == "self_attn" else "mlp"
        key = f"layers.{i}.{group}.{proj}.{'lora_a' if leaf == 'lora_A' else 'lora_b'}"
        if not torch.equal(adapter.get_tensor(name), state8[key].T):
            bad.append(name)
    n_adapter = len(adapter.keys())
    if bad or n_adapter != len(state8):
        raise SmokeFailure(f"H2: adapter tensors differ from the step-8 LoRA tensors: {bad[:3]}")
    del adapter, state8

    merged_dir = art / "merged"
    nbytes = (merged_dir / "model.safetensors").stat().st_size
    cfg = cli.build_model_config(TRAIN_SPEC).replace(param_dtype=torch.bfloat16,
                                                      lora=LoRAConfig())
    model = LlamaForCausalLM(cfg, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    load_pretrained_(model, merged_dir)
    torch.cuda.synchronize()
    reload_s = time.perf_counter() - t0
    served, _ = load_serving_model(art, merge_lora=True, device=DEVICE)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 64)))
    with torch.no_grad():
        want = served(prompt.to(DEVICE))[0, -1].float().cpu()
        got = model.eval()(prompt.to(DEVICE))[0, -1].float().cpu()
    rel = rel_diff(got, want)
    del model, served
    gc.collect()
    torch.cuda.empty_cache()
    log(f"H2: adapter ({n_adapter} f32 tensors) bit-equal to the step-8 LoRA tensors, "
        f"transposed; merged checkpoint ({nbytes / 1e9:.2f} GB f32, {cfg.n_layers} layers) "
        f"exported in {export_s:.1f} s "
        f"({nbytes / export_s / 1e9:.2f} GB/s), reloaded into bf16 through load_pretrained_ in "
        f"{reload_s:.1f} s ({nbytes / reload_s / 1e9:.2f} GB/s); first-token logits vs the "
        f"loader's merge: max |diff| / max |logit| {rel:.4g} (tolerance {MERGED_REL_TOL})")
    if not rel <= MERGED_REL_TOL:
        raise SmokeFailure(f"H2: merged checkpoint logits {rel:.4g} of max |logit| from the "
                           f"loader's merge (tolerance {MERGED_REL_TOL})")
    return {"layers": cfg.n_layers, "merged_bytes": nbytes, "export_s": export_s,
            "export_gb_per_s": nbytes / export_s / 1e9, "reload_s": reload_s,
            "reload_gb_per_s": nbytes / reload_s / 1e9, "logits_rel": rel}


def fidelity_phase(work) -> dict:
    """F: the fidelity proof on the card at the reference's default scale,
    through the port's controller, as ``fidelity.run_proof`` runs it:
    ``pretrain_base`` (full mode on the stdlib corpus, exported as an HF
    directory), a LoRA SFT job from that base submitted with
    ``task_builder`` to the local backend (whose subprocess trainer is
    ``train/cli.py``), read by the monitor and synced to the object store,
    and ``generate_cli`` on the synced artifacts with a held-out prompt;
    the reference's three checks."""
    import torch
    from finetune_controller_tpu_torch.fidelity import run_proof

    t0 = time.perf_counter()
    record = run_proof(work / "fidelity", **FIDELITY, device=DEVICE)
    record["phase_s"] = time.perf_counter() - t0
    record["attention"] = "plain (tiny-test: head dim 16, attention_impl xla)"
    log(f"F: tiny-test on the card through the port's controller, with the plain attention "
        f"path (head dim 16, attention_impl 'xla': the flash kernels are held on the "
        f"full-width phases); pretrain {record['pretrain_steps']} steps on "
        f"{record['corpus_bytes']} corpus bytes: loss {record['pretrain_first_loss']:.3f} -> "
        f"{record['pretrain_final_loss']:.3f}; SFT loss random init "
        f"{record['random_init_loss']:.3f}, base {record['base_eval_loss']:.3f}; job step 1 "
        f"{record['base_step0_loss']:.3f} -> step {record['sft_steps']} "
        f"{record['final_loss']:.3f}; before {record['before_generation']!r}, after "
        f"{record['after_generation']!r}; checks {record['checks']} "
        f"({record['phase_s']:.1f} s)")
    if not record["passed"]:
        raise SmokeFailure(f"F: fidelity checks failed: {record['checks']}")
    torch.cuda.empty_cache()
    return record


#: the phases that run in a process of their own (this script with
#: ``--phase-child``) beside others: F (a small share of the card) beside
#: H1-B, M beside D and K.  Each child counts its own kernel launches; its
#: record is read, and its output printed here, at the join
CHILD_PHASES = {"F": lambda work, seed: fidelity_phase(work),
                "M": lambda work, seed: moe_phase(work, seed)}
#: how long a join waits for its child once the phases beside it are done
CHILD_JOIN_TIMEOUT_S = 300


def phase_start(name: str, work, seed: int) -> dict:
    """Start phase ``name`` of ``CHILD_PHASES`` in a process of its own, its
    output to ``work/phase_<name>.log``, its record to
    ``work/phase_<name>.json``; joined by :func:`phase_finish`."""
    work = Path(work)
    out, logf = work / f"phase_{name}.json", work / f"phase_{name}.log"
    out.unlink(missing_ok=True)
    with open(logf, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--seed", str(seed),
             "--phase-child", name, str(work), str(out)], stdout=f,
            stderr=subprocess.STDOUT, cwd=str(Path(__file__).resolve().parent))
    # a run that fails before the join leaves no child running
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"name": name, "proc": proc, "out": out, "log": logf, "t0": time.perf_counter()}


def phase_finish(child: dict) -> dict:
    """Join a child phase: its output printed here, its record read."""
    name = child["name"]
    try:
        rc = child["proc"].wait(timeout=CHILD_JOIN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        child["proc"].kill()
        rc = "killed after the join's timeout"
    text = child["log"].read_text(errors="replace")
    log(f"--- phase {name}, run in a process of its own: its output ---")
    for line in text.splitlines():
        log(line)
    log(f"--- end of phase {name}'s output ---")
    if rc != 0 or not child["out"].exists():
        raise SmokeFailure(f"{name}: its process exited {rc}; its output's end:\n"
                           + text[-3000:])
    record = json.loads(child["out"].read_text())
    record["joined_after_s"] = time.perf_counter() - child["t0"]
    return record


#: the device phases H1, T2, H2, S2 and F run on ("cpu" drives them at a tiny
#: size without a card), and what the CLIs they call are given for it
DEVICE = "cuda"
DEVICE_ARGS: list[str] = []
#: S2's fleet engines: the service's batch shape, LoRA tenants up to rank
#: 16 in 3 stack slots (base, the job, a rank-8 tenant), a device pool well
#: under the auto size (8 x 36 + 1 pages) and a 32-page device prefix budget,
#: so prefix entries demote to a 1 GiB host tier
S2_ENGINE = dict(slots=8, prompt_buckets=(32, 128, 512), max_new_tokens=64, page_tokens=16,
                 pool_pages=160, tenant_slots=3, tenant_rank=16, host_pool_bytes=1 << 30)
S2_PREFIX_PAGES = 32
#: the replica the fault kills, and at which of its decode steps
S2_FAULT = ("r0", 20)
S2_TENANTS = ("", "job", "r8")


def s2_requests(seed: int, vocab: int):
    """24 requests, 8 each for the base (""), ``job`` and ``r8``, tenants
    interleaved: per tenant 5 unrelated prompts of 20-500 tokens and 3 that
    share one 300-token prefix (the same text in every tenant); 16-48 new
    tokens, greedy."""
    from finetune_controller_tpu_torch.serve.engine import GenRequest

    rng = np.random.default_rng(seed + 5)
    shared = rng.integers(0, vocab, 300).tolist()
    new = [16, 24, 32, 40, 48, 16, 24, 32]
    by_tenant = []
    for aid in S2_TENANTS:
        prompts = [rng.integers(0, vocab, n).tolist() for n in (20, 64, 130, 250, 500)]
        prompts += [shared + rng.integers(0, vocab, n).tolist() for n in (9, 60, 150)]
        by_tenant.append([GenRequest(request_id=f"s2-{aid or 'base'}-{i}", tokens=p,
                                     max_new_tokens=new[i], adapter_id=aid)
                          for i, p in enumerate(prompts)])
    return [reqs[i] for i in range(8) for reqs in by_tenant], shared


def random_adapter(cfg, rank: int, seed: int) -> dict:
    """A seeded rank-``rank`` adapter for every projection of ``cfg``:
    A ~ N(0, 1/in), B ~ N(0, 0.09/rank) (non-zero, so it moves the output)."""
    import torch
    from finetune_controller_tpu_torch.models.llama import tenant_shapes

    gen = torch.Generator().manual_seed(seed)
    tree = {}
    for i in range(cfg.n_layers):
        for proj, (fan_in, fan_out) in tenant_shapes(cfg).items():
            name = f"layers.{i}.{'mlp' if proj in ('gate_proj', 'up_proj', 'down_proj') else 'attn'}.{proj}"
            tree[f"{name}.lora_a"] = torch.randn(fan_in, rank, generator=gen) * fan_in ** -0.5
            tree[f"{name}.lora_b"] = torch.randn(rank, fan_out, generator=gen) * 0.3 * rank ** -0.5
    return tree


def first_logits(model, prompt, tenants=None, slot: int = 0):
    """Last-position logits (f32, host) of a B=1 paged prefill of
    ``prompt`` on a fresh pool — the paged kernel on the card — with the
    row on tenant ``slot`` of ``tenants`` when given."""
    import torch
    from finetune_controller_tpu_torch.models.llama import PagedKV

    bucket, page = 512, 16
    kv = PagedKV.zeros(model.cfg, bucket // page + 1, page, DEVICE)
    table = torch.arange(1, bucket // page + 1, dtype=torch.int32, device=DEVICE)[None, :]
    tokens = torch.zeros((1, bucket), dtype=torch.long, device=DEVICE)
    tokens[0, :len(prompt)] = torch.tensor(prompt, device=DEVICE)
    positions = torch.arange(bucket, dtype=torch.int32, device=DEVICE)[None, :]
    ids = torch.tensor([slot], dtype=torch.int32) if tenants is not None else None
    out = model.forward_paged(tokens, positions, kv, table, torch.zeros(1, dtype=torch.int32,
                                                                        device=DEVICE),
                              last_idx=len(prompt) - 1, adapter_ids=ids, tenants=tenants)
    return out.float()[0].cpu()


def rel_diff(a, b) -> float:
    """max |a - b| / max |b|."""
    return ((a - b).abs().max() / b.abs().max()).item()


def decode_ms(engine, reqs, adapters, steps: int) -> float:
    """Mean host-clock ms of ``steps`` decode steps with every lane busy,
    the lanes' adapters cycling through ``adapters``; each step ends in a
    device-to-host copy of its tokens."""
    import dataclasses

    lanes = [dataclasses.replace(r, request_id=f"m-{i}", adapter_id=adapters[i % len(adapters)],
                                 max_new_tokens=engine.config.max_new_tokens)
             for i, r in enumerate(reqs[:engine.config.slots])]
    for r in lanes:
        engine.admit(r)
    engine.step()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    ms = (time.perf_counter() - t0) / steps * 1e3
    for r in lanes:
        engine.evict(r.request_id)
    return ms


def serve_fleet(fleet_args, reqs, seed: int):
    """Phase S2(b)'s traffic: a fleet of 2 in-process replicas behind the
    router, the fault armed on one; all requests submitted at once.
    Returns the results, the fleet and router stats, and the seconds from
    the kill to the respawned replica taking traffic."""
    from finetune_controller_tpu_torch.resilience.faults import ServeFault, ServeFaultInjector
    from finetune_controller_tpu_torch.resilience.policy import RetryPolicy
    from finetune_controller_tpu_torch.serve.fleet import ReplicaFleet
    from finetune_controller_tpu_torch.serve.router import ReplicaRouter

    model, ecfg, registry, adapters = fleet_args
    fault = ServeFaultInjector(ServeFault(replica_id=S2_FAULT[0], at_step=S2_FAULT[1]))

    async def go():
        fleet = ReplicaFleet(
            "chip-smoke-sft", model, ecfg, replicas=2, adapters=registry, fault=fault,
            batcher_kwargs=dict(max_queue=64), stall_timeout_s=120.0,
            restart_policy=RetryPolicy(max_attempts=3, base_delay_s=0.5, max_delay_s=2.0,
                                       seed=seed))
        try:
            await fleet.start()
            for aid, (tree, alpha, rank) in adapters.items():
                await fleet.register_adapter(aid, tree, alpha, rank)
            fleet.start_health_loop(0.1)
            router = ReplicaRouter(fleet, default_timeout_s=600.0, failover_retries=2)
            marks = {}

            async def watch():
                while "kill" not in marks:
                    if fault.fired:
                        marks["kill"] = time.perf_counter()
                    await asyncio.sleep(0.005)
                while not (fleet.replica_restarts_total and len(fleet.healthy_replicas()) == 2):
                    await asyncio.sleep(0.005)
                marks["back"] = time.perf_counter()

            watcher = asyncio.ensure_future(watch())
            results = await asyncio.gather(*(router.submit(r) for r in reqs))
            try:
                await asyncio.wait_for(watcher, timeout=120.0)
            except asyncio.TimeoutError:
                raise SmokeFailure("S2: the killed replica was not failed and respawned "
                                   f"(fault fired: {fault.fired})") from None
            stats = fleet.stats()
            engines = [r.engine for r in fleet.replicas.values()]
            return results, stats, router.stats(), marks["back"] - marks["kill"], engines
        finally:
            await fleet.close()

    return asyncio.run(go())


def serve_tenants_phase(art, seed: int) -> tuple[int, dict]:
    """S2: serve T2's trained checkpoint.  (a) merged: 4 requests; (b) the
    base with the job's adapter as tenant ``job`` beside a seeded rank-8
    tenant ``r8``, a 2-replica fleet behind the router, the host tier on,
    24 requests with a replica killed mid-run; (c) the unpaged engine
    against ``cached_generate``.  Returns (paged-kernel launches of (b)'s
    traffic, summary)."""
    import dataclasses

    import torch
    from finetune_controller_tpu_torch.models.generate import cached_generate
    from finetune_controller_tpu_torch.models.llama import DenseKV
    from finetune_controller_tpu_torch.ops.kernels.paged_attention import paged_attention
    from finetune_controller_tpu_torch.serve.adapters import AdapterRegistry
    from finetune_controller_tpu_torch.serve.engine import BatchEngine, EngineConfig, GenRequest
    from finetune_controller_tpu_torch.serve.loader import (
        load_serving_model, strip_lora_for_multitenant,
    )

    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    # (a) the merged model serves 4 requests
    t0 = time.perf_counter()
    merged, meta = load_serving_model(art, merge_lora=True)
    load_s = time.perf_counter() - t0
    if not meta["weights_dir"]:
        raise SmokeFailure("S2(a): the loader did not take the base from model.weights_dir")
    cfg = merged.cfg
    reqs, shared = s2_requests(seed, cfg.vocab_size)
    checks = [shared + [11, 12, 13], reqs[9].tokens]  # a shared-prefix prompt, a 250-token one
    engine = BatchEngine(merged, EngineConfig(slots=4, prompt_buckets=(32, 128, 512),
                                              max_new_tokens=32, page_tokens=16))
    four = [dataclasses.replace(r, request_id=f"merged-{i}", adapter_id="", max_new_tokens=32)
            for i, r in enumerate(reqs[:4])]
    done = engine.run(four)
    if sorted(done) != sorted(r.request_id for r in four) or any(
            len(done[r.request_id].generated) != 32 for r in four):
        raise SmokeFailure("S2(a): the merged model did not serve its 4 requests")
    with torch.no_grad():
        merged_logits = [first_logits(merged, p) for p in checks]
    log(f"S2(a): merged model of step {meta['checkpoint_step']} (base from "
        f"{meta['weights_dir']}) loaded in {load_s:.1f} s, "
        "served 4 requests x 32 tokens")
    del merged, engine, done
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the base + the job's adapter as a tenant + r8, a fleet of 2
    t0 = time.perf_counter()
    unmerged, _ = load_serving_model(art, merge_lora=False)
    base, job_tree, alpha, rank = strip_lora_for_multitenant(unmerged)
    del unmerged
    gc.collect()
    torch.cuda.empty_cache()
    load_s = time.perf_counter() - t0
    adapters = {"job": (job_tree, alpha, rank), "r8": (random_adapter(cfg, 8, seed + 8), 16.0, 8)}
    registry = AdapterRegistry(S2_ENGINE["tenant_slots"], S2_ENGINE["tenant_rank"])
    page_bytes = 2 * cfg.n_layers * S2_ENGINE["page_tokens"] * cfg.n_kv_heads * cfg.head_dim * 2
    ecfg = EngineConfig(**S2_ENGINE, prefix_cache_bytes=S2_PREFIX_PAGES * page_bytes)
    paged_attention.launches = 0
    t0 = time.perf_counter()
    try:
        results, stats, rstats, recovery_s, engines = serve_fleet(
            (base, ecfg, registry, adapters), reqs, seed)
    except SmokeFailure:
        raise
    except Exception as e:  # any request failure fails the phase
        raise SmokeFailure(f"S2(b) fleet: {type(e).__name__}: {e}") from e
    traffic_s = time.perf_counter() - t0
    launches = paged_attention.launches
    ids = [r.request_id for r in results]
    if sorted(ids) != sorted(r.request_id for r in reqs) or len(set(ids)) != len(reqs):
        raise SmokeFailure(f"S2(b): {len(set(ids))} distinct of {len(reqs)} requests finished")
    for req, res in zip(reqs, results):
        if res.request_id != req.request_id or len(res.generated) != req.max_new_tokens \
                or res.finish_reason != "length":
            raise SmokeFailure(f"S2(b): bad result for {req.request_id}")
    if stats["requests_completed_total"] != len(reqs):
        raise SmokeFailure(f"S2(b): {stats['requests_completed_total']} completions counted "
                           f"for {len(reqs)} requests")
    if rstats["failovers_total"] < 1 or stats["replica_restarts_total"] < 1:
        raise SmokeFailure(f"S2(b): no failover ({rstats['failovers_total']}) or no respawn "
                           f"({stats['replica_restarts_total']})")
    if stats["kv_demotions_total"] < 1 or stats["prefix_hits_total"] < 1:
        raise SmokeFailure(f"S2(b): {stats['kv_demotions_total']} demotions and "
                           f"{stats['prefix_hits_total']} prefix hits in the traffic")
    # the killed replica's tokens of requests that failed over count too
    want_tokens = {aid: sum(r.max_new_tokens for r in reqs if r.adapter_id == aid)
                   for aid in S2_TENANTS}
    if any(stats["tokens_by_tenant"].get(aid, 0) < n for aid, n in want_tokens.items()):
        raise SmokeFailure(f"S2(b): tokens by tenant {stats['tokens_by_tenant']}, "
                           f"delivered {want_tokens}")
    log(f"S2(b): fleet of 2 replicas sharing one model (base loaded in {load_s:.1f} s), "
        f"{len(reqs)}/{len(reqs)} requests exactly once in {traffic_s:.2f} s, "
        f"{rstats['failovers_total']} failovers, {stats['replica_restarts_total']} respawn, "
        f"failover recovery (kill to respawned replica in service) {recovery_s:.3f} s, "
        f"{launches} paged-kernel launches, {stats['prefix_hits_total']} prefix hits, "
        f"{stats['kv_demotions_total']} pages demoted, {stats['kv_restores_total']} restored")
    log(f"S2(b): tokens by tenant {stats['tokens_by_tenant']}")

    # (b) checks on one more engine with the fleet's registry, its prefix
    # budget wide enough that only the explicit demotion below demotes
    check = BatchEngine(
        base, dataclasses.replace(ecfg, prefix_cache_bytes=4 * ecfg.prefix_cache_bytes),
        adapters=registry)
    slots = {aid: registry.resolve(aid) for aid in S2_TENANTS}
    with torch.no_grad():
        multi = {aid: [first_logits(base, p, check._tenants, slot) for p in checks]
                 for aid, slot in slots.items()}
        one = {}
        for aid in ("job", "r8"):
            tree, a, r = adapters[aid]
            solo = BatchEngine(base, EngineConfig(slots=1, prompt_buckets=(512,),
                                                  max_new_tokens=16, page_tokens=16,
                                                  tenant_slots=2, tenant_rank=r))
            solo.adapters.register(aid, tree, a, r)
            solo.install_adapter(aid)
            one[aid] = [first_logits(base, p, solo._tenants, 1) for p in checks]
            del solo
    rels = {
        "job_vs_one_tenant": max(rel_diff(x, y) for x, y in zip(multi["job"], one["job"])),
        "r8_vs_one_tenant": max(rel_diff(x, y) for x, y in zip(multi["r8"], one["r8"])),
        "job_vs_merged": max(rel_diff(x, y) for x, y in zip(multi["job"], merged_logits)),
        "r8_vs_base": min(rel_diff(x, y) for x, y in zip(multi["r8"], multi[""])),
    }
    log("S2(b): first-token logits, max |diff| / max |logit|: " + ", ".join(
        f"{k} {v:.4g}" for k, v in rels.items()) + f" (tolerance {LOGITS_REL_TOL})")
    for key in ("job_vs_one_tenant", "r8_vs_one_tenant", "job_vs_merged"):
        if not rels[key] <= LOGITS_REL_TOL:
            raise SmokeFailure(f"S2(b): first-token logits {key} {rels[key]:.4g} beyond "
                               f"{LOGITS_REL_TOL}")
    if not rels["r8_vs_base"] > LOGITS_REL_TOL:
        raise SmokeFailure(f"S2(b): r8's logits differ from the base's by only "
                           f"{rels['r8_vs_base']:.4g}: the adapter is not applied")

    def one_request(rid, tokens, aid):
        return check.run([GenRequest(request_id=rid, tokens=tokens, max_new_tokens=24,
                                     adapter_id=aid)])[rid].generated

    one_request("ns-seed", shared + [1], "job")
    hits, misses = check.prefix_hits_total, check.prefix_misses_total
    one_request("ns-other", shared + [2], "r8")
    if (check.prefix_hits_total, check.prefix_misses_total) != (hits, misses + 1):
        raise SmokeFailure("S2(b): a prefix was spliced across adapter namespaces")
    device_tokens = one_request("ns-device", shared + [3], "job")
    if check.prefix_hits_total != hits + 1:
        raise SmokeFailure("S2(b): no prefix hit within one namespace")
    cache = check._prefix_cache
    while cache.stats()["entries_host"] < len(cache):
        cache.demote_or_evict()
    restores = check._host_pool.restores_total
    restored_tokens = one_request("ns-restored", shared + [3], "job")
    if check._host_pool.restores_total <= restores or check.prefix_hits_total != hits + 2:
        raise SmokeFailure("S2(b): no restore hit on a demoted prefix")
    if restored_tokens != device_tokens:
        raise SmokeFailure("S2(b): a request served from a restored prefix gave other greedy "
                           "tokens than from the device-resident prefix")
    tier = {k: sum(e.tier_seconds[k] for e in engines + [check]) for k in ("demote", "restore")}
    pages = {"demote": sum(e._host_pool.demotions_total for e in engines + [check]),
             "restore": sum(e._host_pool.restores_total for e in engines + [check])}
    tier_ms = {k: tier[k] / pages[k] * 1e3 for k in tier if pages[k]}
    log(f"S2(b): host tier {pages['demote']} pages demoted, {pages['restore']} restored "
        f"(traffic + checks): demote {tier_ms.get('demote', float('nan')):.3f} ms/page, "
        f"restore {tier_ms.get('restore', float('nan')):.3f} ms/page (host clock, pages of "
        f"{page_bytes / 1e6:.2f} MB); "
        "restored-prefix tokens equal the device-resident ones")
    ms = {"base_only": [], "three_tenants": []}
    for case in ("base_only", "three_tenants", "three_tenants", "base_only"):
        ms[case].append(decode_ms(check, reqs, ("",) if case == "base_only" else S2_TENANTS,
                                  steps=16))
    step_ms = {k: sum(v) / len(v) for k, v in ms.items()}
    log(f"S2(b): decode with 8 lanes busy: base only {step_ms['base_only']:.2f} ms/step, "
        f"3 tenants {step_ms['three_tenants']:.2f} ms/step (runs {ms})")
    # the same two batches under the profiler: device time per step, which
    # the host's spread does not blur
    prof = {"base_only": profile_decode(check, [dataclasses.replace(r, adapter_id="")
                                                for r in reqs]),
            "three_tenants": profile_decode(check, reqs)}
    for case, p in prof.items():
        if p["device_busy"] is None:
            log(f"S2(b): decode profile {case}: no device time recorded (not measured)")
            continue
        log(f"S2(b): decode profile {case} (8 lanes): {p['step_ms']:.2f} ms/step wall, "
            f"{p['device_ms_per_step']:.2f} ms/step device, busy {p['device_busy']:.3f}")
        for name, kernel_ms in p["top"][:5]:
            log(f"  {kernel_ms:8.3f} ms/step  {name}")
    del check, engines

    # (c) the unpaged engine against cached_generate
    engine = BatchEngine(base, EngineConfig(slots=4, prompt_buckets=(32, 128, 512),
                                            max_new_tokens=32, page_tokens=0))
    four = [dataclasses.replace(r, request_id=f"unpaged-{i}", adapter_id="", max_new_tokens=32)
            for i, r in enumerate(reqs[0:12:3])]
    done = engine.run(four)
    equal, worst_gap = 0, 0.0
    with torch.no_grad():
        for r in four:
            got = done[r.request_id].generated
            if len(got) != 32:
                raise SmokeFailure(f"S2(c): {r.request_id} gave {len(got)} tokens")
            want = cached_generate(base, torch.tensor([r.tokens]), max_new_tokens=32)[0]
            equal += int(want[len(r.tokens):].tolist() == got)
            # the engine's every token against the cached path fed the same
            # tokens: its logit within the bf16 tolerance of the best one
            plen = len(r.tokens)
            kv = DenseKV.zeros(cfg, 1, plen + 32, DEVICE)
            logits = base.forward_cached(
                torch.tensor([r.tokens], device=DEVICE), torch.arange(plen, device=DEVICE)[None],
                kv, torch.zeros(1, dtype=torch.int32, device=DEVICE), fresh=True,
                last_idx=plen - 1).float()[0]
            for t, tok in enumerate(got):
                gap = ((logits.max() - logits[tok]) / logits.abs().max()).item()
                worst_gap = max(worst_gap, gap)
                pos = plen + t
                logits = base.forward_cached(
                    torch.tensor([[tok]], device=DEVICE),
                    torch.full((1, 1), pos, device=DEVICE), kv,
                    torch.full((1,), pos, dtype=torch.int32, device=DEVICE),
                    last_idx=0).float()[0]
    log(f"S2(c): unpaged engine served 4 requests x 32 tokens; {equal} of 4 equal "
        f"cached_generate's greedy tokens; worst logit gap of an engine token under the "
        f"cached path {worst_gap:.4g} of max |logit| (tolerance {LOGITS_REL_TOL})")
    if not worst_gap <= LOGITS_REL_TOL:
        raise SmokeFailure(f"S2(c): an unpaged-engine token is {worst_gap:.4g} of max |logit| "
                           "below the cached path's best")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"S2: serving phase peak memory {peak_gb:.2f} GB (torch.cuda.max_memory_allocated "
        f"after T2 was freed), {time.perf_counter() - t_phase:.1f} s")
    summary = {
        "requests": len(results), "traffic_s": traffic_s, "failovers": rstats["failovers_total"],
        "respawns": stats["replica_restarts_total"], "recovery_s": recovery_s,
        "tokens_by_tenant": stats["tokens_by_tenant"], "prefix_hits": stats["prefix_hits_total"],
        "demoted_pages": pages["demote"], "restored_pages": pages["restore"],
        "demote_ms_per_page": tier_ms.get("demote"), "restore_ms_per_page": tier_ms.get("restore"),
        "decode_ms_per_step": step_ms, "decode_ms_runs": ms,
        "decode_profile": {k: {f: p[f] for f in ("step_ms", "device_ms_per_step", "device_busy")}
                           for k, p in prof.items()},
        "logits_rel": rels,
        "unpaged_equal_cached": equal, "unpaged_worst_gap": worst_gap,
        "peak_memory_gb": peak_gb, "launches": launches,
    }
    return launches, summary


#: phase C: the model, flavor and arguments submitted through the port's
#: server (``seq_len`` 2048 of packed documents: the flash kernels skip
#: tiles); ``profile_steps`` 2 opens the trainer's profiler window at the
#: default ``profile_start_step``, 2, so steps 3 and 4 are traced
CONTROL_MODEL = "llama3-8b-lora"
CONTROL_FLAVOR = "h100"
#: the depth of C's job and of every job on C's model and base (P1, A, R,
#: W), set by an operator plugin (``LLAMA_CUT_PLUGIN``; ``DPO_PLUGIN`` for
#: P1, whose adapter W1 loads onto C's base): the run must end inside
#: 1200 s on the slower card machines (all 32 until this cut, with which a
#: whole run took 961.2 s on an NVIDIA H100 80GB HBM3 at 700 W)
C_LAYERS = 8
CONTROL_ARGS = {"lora_rank": 16, "batch_size": 4, "seq_len": 2048, "grad_accum_steps": 2,
                "total_steps": 6, "checkpoint_every": 6, "log_every": 1, "profile_steps": 2,
                "warmup_steps": 2, "learning_rate": 2e-4}
#: the greedy requests sent to ``POST /jobs/{id}/generate`` (prompt tokens)
CONTROL_PROMPTS = (20, 130, 377, 500)
CONTROL_NEW_TOKENS = 32
#: the control plane's settings (``FTC_*``): the monitor in process at a
#: short interval, the paged KV cache on so ``/generate`` reaches the paged
#: kernel; auth on with a dev token; no retries, so a failed job fails the run;
#: C, Q and V2 promote three jobs within a minute (the default allows two)
CONTROL_ENV = {
    "FTC_ENVIRONMENT": "local", "FTC_BACKEND": "local", "FTC_MONITOR_IN_PROCESS": "true",
    "FTC_JOB_MONITOR_INTERVAL_S": "0.5", "FTC_ARTIFACT_SYNC_INTERVAL_S": "5",
    "FTC_SERVE_PAGED_KV": "true", "FTC_AUTH_ENABLED": "true", "FTC_RETRY_MAX_ATTEMPTS": "0",
    "FTC_RATE_LIMIT_PROMOTE_PER_MIN": "10",
}
#: how long the job may take from submit to SUCCEEDED
CONTROL_JOB_TIMEOUT_S = 900
#: Q: the int4 QLoRA example through the same server (``mistral-7b``, the
#: ``jax_qlora`` framework sets ``quantize_base``), C's batch shape and
#: steps with no profiler window
QLORA_MODEL = "mistral-7b-qlora"
QLORA_ARGS = {k: v for k, v in CONTROL_ARGS.items() if k != "profile_steps"}
#: Q's depth, set by an operator plugin (``QLORA_PLUGIN``): the run must end
#: inside 1200 s on the slower card machines (16 layers until phases A, J, N
#: and B came; with them at 16 a whole run took 1095.8 s on an NVIDIA H100
#: 80GB HBM3 at 700 W)
QLORA_LAYERS = 8
QLORA_PLUGIN = '''"""``mistral-7b-qlora`` at {layers} of its 32 layers."""

from finetune_controller_tpu_torch.controller.examples import Mistral7B_QLoRA


class Mistral7B_QLoRA_Cut(Mistral7B_QLoRA):
    def build_trainer_spec(self, job_id, artifacts_dir, **kw):
        spec = super().build_trainer_spec(job_id, artifacts_dir, **kw)
        spec["model"].setdefault("overrides", {{}})["n_layers"] = {layers}
        return spec
'''


class _Api:
    """A ``urllib`` client of the control plane's HTTP API."""

    def __init__(self, base: str, token: str = ""):
        self.base = base
        self.token = token

    def call(self, method: str, path: str, body=None, *, fields=None, files=None,
             raw: bool = False):
        import urllib.error
        import urllib.request

        headers = {"Authorization": f"Bearer {self.token}"} if self.token else {}
        data = None
        if fields is not None or files is not None:
            boundary = f"chipsmoke{os.urandom(8).hex()}"
            parts = []
            for name, value in (fields or {}).items():
                parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                             f'name="{name}"\r\n\r\n{value}\r\n'.encode())
            for name, (filename, payload) in (files or {}).items():
                parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; '
                             f'filename="{filename}"\r\nContent-Type: application/jsonl'
                             f'\r\n\r\n'.encode() + payload + b"\r\n")
            data = b"".join(parts) + f"--{boundary}--\r\n".encode()
            headers["Content-Type"] = f"multipart/form-data; boundary={boundary}"
        elif body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(self.base + path, data=data, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                status, payload = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            status, payload = e.code, e.read()
        return status, (payload.decode() if raw else json.loads(payload or b"null"))

    def ok(self, method: str, path: str, body=None, want=(200,), **kw):
        status, out = self.call(method, path, body, **kw)
        if status not in want:
            raise SmokeFailure(f"C: {method} {path} answered {status}: {out}")
        return out


def tree_bytes(path) -> int:
    """Bytes of the files under ``path`` (what a phase left on disk: its
    writes, less what it deleted)."""
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def _prom_value(text: str, name: str) -> float:
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return 0.0


def _follow_job(api, job_id: str, t_submit: float, tag: str,
                on_poll=None) -> tuple[dict, dict, list]:
    """Poll ``GET /jobs/{id}`` until the job ends (``on_poll(job)`` after
    each poll of a live job); fail unless it SUCCEEDED after being seen
    RUNNING.  Returns (job, first time each status was seen, log lines)."""
    seen, job = {}, {}
    while time.time() - t_submit < CONTROL_JOB_TIMEOUT_S:
        job = api.ok("GET", f"/jobs/{job_id}")
        seen.setdefault(job["status"], time.time())
        if job["status"] in ("succeeded", "failed", "cancelled"):
            break
        if on_poll is not None:
            on_poll(job)
        time.sleep(0.5)
    logs = api.ok("GET", f"/jobs/{job_id}/logs")["lines"]
    if job.get("status") != "succeeded":
        tail = "\n".join(logs[-30:])
        raise SmokeFailure(f"{tag}: job {job_id} ended {job.get('status')} "
                           f"({job.get('message') or job.get('metadata')}); log tail:\n{tail}")
    if "running" not in seen:
        raise SmokeFailure(f"{tag}: the job was never seen RUNNING (seen {sorted(seen)})")
    return job, seen, logs


def _job_rows(api, job_id: str, steps: int, tag: str) -> list[dict]:
    """The job's ``/metrics`` rows, oldest first: one per step, finite losses."""
    records = api.ok("GET", f"/jobs/{job_id}/metrics")["records"][::-1]
    losses = [r.get("loss") for r in records]
    if [r.get("step") for r in records] != list(range(1, steps + 1)) or not all(
            isinstance(x, float) and math.isfinite(x) for x in losses):
        raise SmokeFailure(f"{tag}: /metrics rows "
                           f"{[(r.get('step'), r.get('loss')) for r in records]}")
    return records


def _timeline(api, job_id: str, want: tuple[str, ...], tag: str) -> tuple[list, dict]:
    """The job's timeline events and the first time of each; fails when an
    event of ``want`` is missing."""
    timeline = api.ok("GET", f"/jobs/{job_id}/timeline")["events"]
    at = {}
    for e in timeline:
        at.setdefault(e["event"], e["ts"])
    for name in want:
        if name not in at:
            raise SmokeFailure(f"{tag}: no {name!r} on the timeline {sorted(at)}")
    return timeline, at


def _promote(api, job_id: str, tag: str) -> float:
    """``POST /promote`` until COMPLETED: the seconds it took."""
    t0 = time.time()
    api.ok("POST", f"/jobs/{job_id}/promote", want=(202,))
    job = {}
    while time.time() - t0 < 600:
        job = api.ok("GET", f"/jobs/{job_id}")
        if job["promotion_status"] in ("completed", "failed"):
            break
        time.sleep(0.2)
    if job.get("promotion_status") != "completed":
        raise SmokeFailure(f"{tag}: promotion ended {job.get('promotion_status')}")
    return time.time() - t0


def _promote_and_load(api, job_id: str, tag: str) -> tuple[float, float, dict]:
    """:func:`_promote`, then ``POST /admin/serve/{id}/load``: (promote s,
    load s, the served model's meta)."""
    promote_s = _promote(api, job_id, tag)
    t0 = time.time()
    meta = api.ok("POST", f"/admin/serve/{job_id}/load")["model"]
    return promote_s, time.time() - t0, meta


def int4_base_bytes(model) -> dict:
    """Bytes of a model's base on the card: int4 packed kernels, their
    scales, and every other base tensor (embedding, head, norms, router),
    the LoRA leaves left out."""
    out = {"packed": 0, "scales": 0, "float": 0}
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        if name.endswith((".lora_a", ".lora_b")) or name == "inv_freqs":
            continue
        kind = ("packed" if name.endswith("_packed") else
                "scales" if name.endswith("_scales") else "float")
        out[kind] += t.numel() * t.element_size()
    return out


def _generate_against_engine(ctx, job_id: str, vocab: int, prompt_lens, new_tokens: int,
                             seed: int, tag: str) -> dict:
    """Greedy ``POST /jobs/{id}/generate`` requests, sent concurrently, held
    token for token against an in-process ``BatchEngine`` (the service's
    ``EngineConfig``) on the model the loader builds from the same promoted
    prefix.  The paged kernel's count is zeroed just before the requests
    and read just after; it must rise."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from finetune_controller_tpu_torch.ops.kernels import paged_attention as pa
    from finetune_controller_tpu_torch.serve.engine import BatchEngine, GenRequest
    from finetune_controller_tpu_torch.serve.loader import load_promoted

    api, scrape, rt, settings, on_loop, ctrl = ctx
    rng = np.random.default_rng(seed + 7)
    prompts = [rng.integers(0, vocab, n).tolist() for n in prompt_lens]
    metrics0 = scrape.ok("GET", "/metrics", raw=True)
    pa.paged_attention.launches = 0

    def generate(i):
        return api.ok("POST", f"/jobs/{job_id}/generate", {
            "tokens": prompts[i], "max_new_tokens": new_tokens, "request_id": f"{tag}{i}"})

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(prompts)) as pool:
        answers = list(pool.map(generate, range(len(prompts))))
    wall = time.perf_counter() - t0
    launches = pa.paged_attention.launches
    prom = scrape.ok("GET", "/metrics", raw=True)
    ttft_n = _prom_value(prom, "ftc_serve_ttft_seconds_count") - _prom_value(
        metrics0, "ftc_serve_ttft_seconds_count")
    ttft_s = (_prom_value(prom, "ftc_serve_ttft_seconds_sum") - _prom_value(
        metrics0, "ftc_serve_ttft_seconds_sum")) / max(ttft_n, 1)
    ok = [a for a in answers if len(a["tokens"]) == new_tokens
          and a["finish_reason"] == "length"]
    generated = sum(len(a["tokens"]) for a in answers)

    ref_model, _ = on_loop(load_promoted(
        rt.state, rt.store, job_id, ctrl / f"reference_{tag}",
        merge_lora=settings.serve_merge_lora, device=DEVICE), 900)
    base_bytes = int4_base_bytes(ref_model)
    engine = BatchEngine(ref_model, rt.serve._engine_config())
    ref = engine.run([GenRequest(request_id=f"{tag}{i}", tokens=p, max_new_tokens=new_tokens)
                      for i, p in enumerate(prompts)])
    differ = [a["request_id"] for a in answers
              if a["tokens"] != ref[a["request_id"]].generated]
    del engine, ref_model
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    if len(ok) != len(prompts) or differ:
        raise SmokeFailure(f"{tag}: {len(ok)}/{len(prompts)} requests complete; tokens differ "
                           f"from the in-process engine on {differ}")
    if DEVICE == "cuda" and launches <= 0:
        raise SmokeFailure(f"{tag}: the paged-attention kernel was not launched by /generate")
    on_loop(rt.serve.unload(job_id), 300)
    # the served model's blocks go back to the card, not to this process's
    # cache: the next job runs in a process of its own
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return {"paged_launches": launches, "ttft_s": ttft_s,
            "decode_tokens_per_s": generated / wall, "requests_ok": len(ok),
            "requests": len(prompts), "generated_tokens": generated,
            "base_bytes": base_bytes, "prompts": prompts,
            "answers": {a["request_id"]: a["tokens"] for a in answers}}


def control_phase(work, seed: int) -> tuple[dict, dict, dict, dict, dict]:
    """C, Q, V2 and P1: the control plane on the card.  The port's server runs in
    this process on an ephemeral port, on its own event-loop thread, with a
    fresh state dir and object store under ``build/chip_smoke_ctrl``.  A dev
    token's user uploads T2's seeded documents (``POST /datasets``).

    C submits ``CONTROL_MODEL`` on ``CONTROL_FLAVOR`` as multipart and
    follows the job QUEUED -> RUNNING -> SUCCEEDED: the fair-share scheduler
    admits it, the local backend runs ``python -m
    finetune_controller_tpu_torch.train.cli`` on the card, the monitor reads
    it to the end.  Checked: 6 metrics rows with finite losses, the logs,
    the timeline, ``/trace`` with no problems, and the profiler trace the
    job wrote (``profile/``), which must list launches of each flash kernel
    (``FLASH_KERNEL_SYMBOLS``).  Then the job is promoted, loaded, and 4
    greedy requests go to ``POST /jobs/{id}/generate``
    (:func:`_generate_against_engine`).

    Q then submits ``QLORA_MODEL`` (an int4 base quantized at init from the
    job's seed) on the same server and dataset, with no profiler window,
    and follows it the same way; its promoted checkpoint must load
    unmerged (``lora_merged: false``) and serve 4 ``/generate`` requests
    equal to the in-process engine on the int4 base.  V2 then runs
    ``LLAVA_MODEL`` on the same server (:func:`_llava_job`), and P1
    ``DPO_MODEL`` on seeded preference rows uploaded with ``POST /datasets``
    (:func:`_dpo_job`; the held-out rows through ``DPO_PLUGIN``, from the
    registry's plugin directory).  A then serves C's promoted job from a
    server with ``serve_autoscale`` on (:func:`serve_tenant_phase`).
    Returns C's, Q's, V2's, P1's and A's records."""
    t_phase = time.perf_counter()
    ctrl = Path(__file__).resolve().parent / "build" / "chip_smoke_ctrl"
    shutil.rmtree(ctrl, ignore_errors=True)
    ctrl.mkdir(parents=True)
    docs = Path(work) / "train.jsonl"
    if not docs.exists():
        write_documents(docs, seed)
    prefs, prefs_eval = preference_rows(work, seed)
    (ctrl / "plugins").mkdir()
    (ctrl / "plugins" / "dpo_held_out.py").write_text(
        DPO_PLUGIN.format(eval_path=str(prefs_eval), layers=C_LAYERS))
    (ctrl / "plugins" / "qlora_depth.py").write_text(QLORA_PLUGIN.format(layers=QLORA_LAYERS))
    (ctrl / "plugins" / "llama_depth.py").write_text(LLAMA_CUT_PLUGIN.format(layers=C_LAYERS))
    (ctrl / "plugins" / "llava_depth.py").write_text(LLAVA_CUT_PLUGIN.format(layers=LLAVA_LAYERS))
    with control_plane(ctrl, CONTROL_ENV, plugin_dir=ctrl / "plugins") as ctx:
        api = ctx[0]
        dataset = api.ok("POST", "/datasets", files={"file": ("train.jsonl", docs.read_bytes())},
                         want=(201,))
        record = _control_job(ctx, dataset["dataset_id"], seed)
        record["control_dir_bytes"] = tree_bytes(ctrl)
        record["phase_s"] = time.perf_counter() - t_phase
        DISK.mark("C")
        t_q = time.perf_counter()
        qlora = _qlora_job(ctx, dataset["dataset_id"], seed)
        qlora["phase_s"] = time.perf_counter() - t_q
        qlora["control_dir_bytes"] = tree_bytes(ctrl)
        DISK.mark("Q")
        t_v = time.perf_counter()
        llava = _llava_job(ctx, seed)
        llava["phase_s"] = time.perf_counter() - t_v
        llava["control_dir_bytes"] = tree_bytes(ctrl)
        DISK.mark("V2")
        t_p = time.perf_counter()
        dpo_dataset = api.ok("POST", "/datasets",
                             files={"file": ("prefs.jsonl", prefs.read_bytes())}, want=(201,))
        dpo = _dpo_job(ctx, dpo_dataset["dataset_id"], seed)
        dpo["phase_s"] = time.perf_counter() - t_p
    dpo["control_dir_bytes"] = tree_bytes(ctrl)
    DISK.mark("P1")
    tenant = serve_tenant_phase(work, seed, record, dataset["dataset_id"])
    tenant["control_dir_bytes"] = tree_bytes(ctrl)
    return record, qlora, llava, dpo, tenant


@contextlib.contextmanager
def control_plane(ctrl: Path, env_overrides: dict, plugin_dir: Path | None = None):
    """The port's server in this process on an ephemeral port, on its own
    event-loop thread, with ``env_overrides`` (``FTC_*``) set and a fresh
    state dir and object store under ``ctrl``; an admin dev token is minted.
    Yields ``(api, scrape, rt, settings, on_loop, ctrl)``; the environment
    is restored on exit."""
    import threading

    import torch
    from finetune_controller_tpu_torch.controller import config as ctl_config
    from finetune_controller_tpu_torch.controller import registry, web
    from finetune_controller_tpu_torch.controller.runtime import build_runtime
    from finetune_controller_tpu_torch.controller.server import build_app

    env = {**env_overrides, "FTC_STATE_DIR": str(ctrl / "state"),
           "FTC_OBJECT_STORE_ROOT": str(ctrl / "objects"), "FTC_DEVICE": DEVICE}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    ctl_config.set_settings(None)
    settings = ctl_config.get_settings()
    registry.reset()
    rt = build_runtime(settings, plugin_dir=str(plugin_dir) if plugin_dir else None)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="control-plane", daemon=True)
    thread.start()

    def on_loop(coro, timeout=None):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    runner = web.AppRunner(build_app(rt))
    try:
        on_loop(runner.setup(), 60)
        site = web.TCPSite(runner, "127.0.0.1", 0)
        on_loop(site.start(), 60)
        api = _Api(f"http://127.0.0.1:{site.port}{settings.api_prefix}")
        scrape = _Api(f"http://127.0.0.1:{site.port}")  # /metrics sits at the root
        api.ok("GET", "/health")
        api.token = api.ok("POST", "/auth/dev-token",
                           {"user_id": "chip-smoke", "is_admin": True})["access_token"]
        yield api, scrape, rt, settings, on_loop, ctrl
    finally:
        on_loop(runner.cleanup(), 300)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        loop.close()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        ctl_config.set_settings(None)
        if DEVICE == "cuda":
            torch.cuda.empty_cache()


def _control_job(ctx, dataset_id: str, seed: int) -> dict:
    """C's job: ``CONTROL_MODEL`` with a profiler window, through SUCCEEDED,
    promotion and ``/generate``."""
    api, scrape, rt, settings, on_loop, ctrl = ctx
    t_submit = time.time()
    job_id = api.ok("POST", "/jobs", fields={
        "model_name": CONTROL_MODEL, "device": CONTROL_FLAVOR,
        "dataset_id": dataset_id, "arguments": json.dumps(CONTROL_ARGS)})["job_id"]
    job, seen, logs = _follow_job(api, job_id, t_submit, "C")
    order = [st for st in ("queued", "running", "succeeded") if st in seen]
    native = [line for line in logs if "native packer produced" in line]
    if not native:
        raise SmokeFailure("C: the job's log has no line of the native JSONL packer")
    records = _job_rows(api, job_id, CONTROL_ARGS["total_steps"], "C")
    losses = [r["loss"] for r in records]
    timeline, at = _timeline(api, job_id, (
        "submitted", "running", "train-started", "checkpoint-committed", "profile-captured",
        "train-finished", "succeeded"), "C")
    trace = api.ok("GET", f"/jobs/{job_id}/trace")
    if trace["problems"]:
        raise SmokeFailure(f"C: /trace problems {trace['problems']}")
    listing = api.ok("GET", f"/jobs/{job_id}/artifacts?list=1")["artifacts"]
    profiles = [a["path"] for a in listing if a["path"].startswith("profile/")
                and a["path"].endswith(".json")]
    if not profiles:
        raise SmokeFailure(f"C: the job's artifacts hold no profile/ trace: "
                           f"{sorted(a['path'] for a in listing)[:20]}")
    profile_bytes = on_loop(rt.store.get_bytes(f"{job['artifacts_uri']}/{profiles[0]}"), 300)
    events = json.loads(profile_bytes).get("traceEvents", [])
    kernel_names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    seen_launches = {name: sum(sym in k for k in kernel_names)
                     for name, sym in FLASH_KERNEL_SYMBOLS.items()}
    missing = [n for n in FLASH_KERNELS if seen_launches.get(n, 0) <= 0]
    if missing:
        raise SmokeFailure(f"C: the job's profile lists no launch of {missing} "
                           f"({len(kernel_names)} kernel events)")
    tokens = CONTROL_ARGS["batch_size"] * CONTROL_ARGS["seq_len"]
    step_ms = [tokens / r["tokens_per_sec"] * 1e3 for r in records]
    # the window's 0-based steps [a, b) are the rows of steps a+1 .. b
    m = re.fullmatch(r"profile/steps_(\d+)-(\d+)\.pt\.trace\.json", profiles[0])
    if m is None:
        raise SmokeFailure(f"C: unexpected profile trace name {profiles[0]!r}")
    profiled_steps = list(range(int(m.group(1)) + 1, int(m.group(2)) + 1))
    phases = {c: [r.get(c) for r in records]
              for c in ("phase_compute_ms", "phase_input_ms", "phase_sync_ms",
                        "phase_checkpoint_ms")}
    first_row_ts = records[0]["timestamp"]
    promote_s, load_s, meta = _promote_and_load(api, job_id, "C")
    served = _generate_against_engine(ctx, job_id, meta["vocab_size"], CONTROL_PROMPTS,
                                      CONTROL_NEW_TOKENS, seed, "c")
    job_bytes = tree_bytes(settings.state_path / "sandboxes" / job_id)
    # step 1 pays the first-use costs and the profiled steps pay the
    # profiler: the job's step time is the median of the others
    steady = sorted(ms for r, ms in zip(records, step_ms)
                    if r["step"] > 1 and r["step"] not in profiled_steps)
    median = steady[len(steady) // 2]
    record = {
        "job_id": job_id, "model": CONTROL_MODEL, "device": CONTROL_FLAVOR,
        "statuses": order, "losses": losses,
        "submit_to_running_s": seen["running"] - t_submit,
        "submit_to_train_started_s": at["train-started"] - at["submitted"],
        "submit_to_first_step_s": first_row_ts - at["submitted"],
        "ms_per_step": step_ms, "phase_ms": phases, "profiled_steps": profiled_steps,
        "ms_per_step_median": median, "tokens_per_s_median": tokens / (median / 1e3),
        "median_over_steps": [r["step"] for r in records
                              if r["step"] > 1 and r["step"] not in profiled_steps],
        "promote_s": promote_s, "model_load_s": load_s,
        **{k: served[k] for k in ("ttft_s", "decode_tokens_per_s", "requests_ok", "requests",
                                  "generated_tokens", "paged_launches", "prompts", "answers")},
        "flash_launches_in_profile": seen_launches,
        "profile": profiles[0], "profile_bytes": len(profile_bytes),
        "log_lines": len(logs), "timeline_events": len(timeline),
        "job_sandbox_bytes": job_bytes, "native_packer_log": native[0][-200:],
    }
    log(f"control: {CONTROL_MODEL} on {CONTROL_FLAVOR} through the port's server: "
        f"{' -> '.join(order)}; submit -> RUNNING {record['submit_to_running_s']:.1f} s, "
        f"-> train-started {record['submit_to_train_started_s']:.1f} s, -> first step "
        f"{record['submit_to_first_step_s']:.1f} s; steps "
        f"{[round(x) for x in step_ms]} ms (steps {profiled_steps} profiled), "
        f"{median:.0f} ms/step median of steps {record['median_over_steps']}, "
        f"{record['tokens_per_s_median']:.0f} tokens/s; promote {promote_s:.2f} s, "
        f"model load {load_s:.1f} s; TTFT {served['ttft_s'] * 1e3:.1f} ms, decode "
        f"{served['decode_tokens_per_s']:.1f} tokens/s over {served['requests']} requests "
        f"({served['requests_ok']}/{served['requests']} ok, tokens equal to the in-process "
        f"engine); flash launches in the profile {seen_launches}; paged launches "
        f"{served['paged_launches']}; the job's sandbox holds {job_bytes / 1e9:.2f} GB")
    return record


class CardMemorySampler:
    """The card's used memory (``nvidia-smi``, MB, every process on it)
    sampled on a thread: its growth over the value at start measures a job
    that runs in another process (caching allocator and CUDA context
    included).  ``None`` without a card."""

    def __init__(self, interval_s: float = 0.5):
        import threading

        self.interval_s = interval_s
        self.samples: list[float] = []
        self._stop = threading.Event()
        self.base = self.read()
        self._thread = threading.Thread(target=self._run, name="memory-sampler", daemon=True)

    @staticmethod
    def read() -> float | None:
        if DEVICE != "cuda":
            return None
        out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0]) if out.returncode == 0 else None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            value = self.read()
            if value is not None:
                self.samples.append(value)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(30)

    @property
    def peak_gb(self) -> float | None:
        if self.base is None or not self.samples:
            return None
        return (max(self.samples) - self.base) * 2**20 / 1e9


def _qlora_job(ctx, dataset_id: str, seed: int) -> dict:
    """Q's job: ``QLORA_MODEL`` (int4 base from the job's seed, LoRA rank 16
    on all seven projections) through SUCCEEDED, promotion, an unmerged
    load and ``/generate``."""
    api, scrape, rt, settings, on_loop, ctrl = ctx
    t_submit = time.time()
    with CardMemorySampler() as memory:
        job_id = api.ok("POST", "/jobs", fields={
            "model_name": QLORA_MODEL, "device": CONTROL_FLAVOR,
            "dataset_id": dataset_id, "arguments": json.dumps(QLORA_ARGS)})["job_id"]
        job, seen, logs = _follow_job(api, job_id, t_submit, "Q")
    order = [st for st in ("queued", "running", "succeeded") if st in seen]
    records = _job_rows(api, job_id, QLORA_ARGS["total_steps"], "Q")
    _, at = _timeline(api, job_id, ("submitted", "running", "train-started",
                                    "checkpoint-committed", "train-finished", "succeeded"), "Q")
    tokens = QLORA_ARGS["batch_size"] * QLORA_ARGS["seq_len"]
    step_ms = [tokens / r["tokens_per_sec"] * 1e3 for r in records]
    steady = sorted(step_ms[1:])
    median = steady[len(steady) // 2]
    promote_s, load_s, meta = _promote_and_load(api, job_id, "Q")
    if meta.get("lora_merged") is not False:
        raise SmokeFailure(f"Q: the int4 job loaded with lora_merged={meta.get('lora_merged')}")
    served = _generate_against_engine(ctx, job_id, meta["vocab_size"], CONTROL_PROMPTS,
                                      CONTROL_NEW_TOKENS, seed + 1, "q")
    base = served["base_bytes"]
    if not base["packed"]:
        raise SmokeFailure(f"Q: the served model holds no int4 kernels ({base})")
    record = {
        "job_id": job_id, "model": QLORA_MODEL, "device": CONTROL_FLAVOR,
        "statuses": order, "losses": [r["loss"] for r in records],
        "submit_to_running_s": seen["running"] - t_submit,
        "submit_to_train_started_s": at["train-started"] - at["submitted"],
        "submit_to_first_step_s": records[0]["timestamp"] - at["submitted"],
        "ms_per_step": step_ms, "ms_per_step_median": median,
        "tokens_per_s_median": tokens / (median / 1e3),
        "phase_compute_ms": [r.get("phase_compute_ms") for r in records],
        "promote_s": promote_s, "model_load_s": load_s, "lora_merged": meta["lora_merged"],
        **{k: served[k] for k in ("ttft_s", "decode_tokens_per_s", "requests_ok", "requests",
                                  "generated_tokens", "paged_launches")},
        "served_base_bytes": base, "job_peak_memory_gb": memory.peak_gb,
        "log_lines": len(logs),
        "job_sandbox_bytes": tree_bytes(settings.state_path / "sandboxes" / job_id),
    }
    log(f"qlora: {QLORA_MODEL} on {CONTROL_FLAVOR} through the port's server: "
        f"{' -> '.join(order)}; submit -> RUNNING {record['submit_to_running_s']:.1f} s, "
        f"-> first step {record['submit_to_first_step_s']:.1f} s; steps "
        f"{[round(x) for x in step_ms]} ms, {median:.0f} ms/step median of steps 2-"
        f"{len(records)}, {record['tokens_per_s_median']:.0f} tokens/s; the job's peak "
        f"card memory (nvidia-smi, above the value at submit) "
        f"{memory.peak_gb if memory.peak_gb is None else round(memory.peak_gb, 2)} GB; promote "
        f"{promote_s:.2f} s, load {load_s:.1f} s (lora_merged false); TTFT "
        f"{served['ttft_s'] * 1e3:.1f} ms, {served['decode_tokens_per_s']:.1f} generated "
        f"tokens/s, {served['requests_ok']}/{served['requests']} equal to the in-process "
        f"engine; paged launches {served['paged_launches']}; int4 base on the card: packed "
        f"{base['packed'] / 1e9:.3f} GB, scales {base['scales'] / 1e9:.3f} GB, other base "
        f"tensors {base['float'] / 1e9:.3f} GB (serving dtype)")
    return record


#: Q0: one full-width Mixtral expert stack ``(E, d, d_ff)`` and the rows per
#: expert of M's microbatch (capacity 1280 at t = 4096)
INT4_STACK = (8, 4096, 14336)
INT4_ROWS = 1280
#: Q0: the int4 product and its ``grad_x`` against dequantize-then-matmul:
#: max |diff| / max |reference| (both round one bf16 product; 2**-8 is one
#: bf16 ulp at the largest element)
INT4_REL_TOL = 2.0 ** -8


def int4_check(seed: int) -> dict:
    """Q0: ``quantize_int4`` of a seeded full-width expert stack on the card
    equals the plain version on the CPU bit for bit (packed bytes, scales,
    and the dequantized bf16 stack); ``int4_matmul``'s forward and
    ``grad_x`` at M's expert shapes against dequantize-then-``matmul``
    (``INT4_REL_TOL``), with CUDA-event times of both."""
    import torch
    from finetune_controller_tpu_torch.models import quant

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 3)
    w = torch.randn(INT4_STACK, generator=gen, device=DEVICE) * INT4_STACK[1] ** -0.5
    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    packed, scales = quant.quantize_int4(w)
    sync()
    card_s = time.perf_counter() - t0
    w_cpu = w.cpu()
    del w
    t0 = time.perf_counter()
    p_cpu, s_cpu = quant.quantize_int4(w_cpu)
    cpu_s = time.perf_counter() - t0
    del w_cpu
    diff_p = int((packed.cpu() != p_cpu).sum())
    diff_s = int((scales.cpu().view(torch.int16) != s_cpu.view(torch.int16)).sum())
    if diff_p or diff_s:
        raise SmokeFailure(f"Q0: quantize_int4 on the card differs from the CPU's in {diff_p} "
                           f"packed bytes and {diff_s} scales")
    deq = quant.dequantize_int4(packed, scales, dtype=torch.bfloat16)
    if not torch.equal(deq.cpu().view(torch.int16),
                       quant.dequantize_int4(p_cpu, s_cpu, dtype=torch.bfloat16).view(torch.int16)):
        raise SmokeFailure("Q0: dequantize_int4 on the card differs from the CPU's")
    del p_cpu, s_cpu
    e, d, f = INT4_STACK
    x = (torch.randn((e, INT4_ROWS, d), generator=gen, device=DEVICE)
         .to(torch.bfloat16).requires_grad_(True))
    gy = torch.randn((e, INT4_ROWS, f), generator=gen, device=DEVICE).to(torch.bfloat16)
    y = quant.int4_matmul(x, packed, scales, torch.bfloat16)
    y.backward(gy)
    with torch.no_grad():
        y_ref = x @ deq
        gx_ref = gy @ deq.transpose(-1, -2)
    err_y = ((y.detach() - y_ref).abs().max() / y_ref.abs().max()).item()
    err_gx = ((x.grad - gx_ref).abs().max() / gx_ref.abs().max()).item()
    if not (err_y <= INT4_REL_TOL and err_gx <= INT4_REL_TOL):
        raise SmokeFailure(f"Q0: int4_matmul vs dequantize-then-matmul: forward {err_y:.3g}, "
                           f"grad_x {err_gx:.3g} (tolerance {INT4_REL_TOL:.3g})")

    def timed(fn, reps=5):
        fn()
        if DEVICE != "cuda":
            return None  # a device time only
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    with torch.no_grad():
        ms = {"dequantize": timed(lambda: quant.dequantize_int4(packed, scales)),
              "int4_matmul": timed(lambda: quant.int4_matmul(x, packed, scales, torch.bfloat16)),
              "bf16_matmul": timed(lambda: x @ deq)}
    out = {"shape": list(INT4_STACK), "rows": INT4_ROWS, "quantize_card_s": card_s,
           "quantize_cpu_s": cpu_s, "bit_equal": True, "err_forward": err_y,
           "err_grad_x": err_gx, "ms": ms,
           "packed_bytes": packed.numel(), "scales_bytes": scales.numel() * 2}
    del packed, scales, deq, x, gy, y, y_ref, gx_ref
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    if DEVICE != "cuda":
        return out
    log(f"Q0 int4: quantize_int4 of {INT4_STACK} on the card ({card_s:.2f} s) equals the CPU's "
        f"({cpu_s:.1f} s) bit for bit, dequantized too; int4_matmul at ({e}, {INT4_ROWS}, {d}) "
        f"forward rel err {err_y:.3g}, grad_x {err_gx:.3g} (tolerance {INT4_REL_TOL:.3g}); "
        f"dequantize {ms['dequantize']:.3f} ms, int4_matmul {ms['int4_matmul']:.3f} ms, "
        f"bf16 matmul on the dequantized stack {ms['bf16_matmul']:.3f} ms")
    return out


#: M: Mixtral-8x7B with int4 experts at full width and depth (the preset's
#: ``full`` remat), LoRA rank 16 on the attention projections (the experts
#: carry none), bf16 for the other frozen tensors; T2's batch shape
#: M's depth: the run must end inside 1200 s on the slower card machines
#: (with M at 32 layers a whole run took 1141 s on one H100 machine; at 16,
#: with phases A, J, N and B, 1095.8 s, M itself 63.5 s, on an NVIDIA H100
#: 80GB HBM3 at 700 W)
MOE_LAYERS = 8
MOE_SPEC = {
    "job_id": "chip-smoke-moe",
    "model": {"preset": "mixtral-8x7b", "lora": {"rank": 16, "alpha": 32.0},
              "overrides": {"quantize_base": True, "n_layers": MOE_LAYERS}},
    "training": {"mode": "lora", "frozen_dtype": "bfloat16", "batch_size": 4, "seq_len": 2048,
                 "grad_accum_steps": 2, "total_steps": 4, "warmup_steps": 2,
                 "learning_rate": 2e-4, "log_every": 1, "checkpoint_every": 4,
                 "heartbeat_interval_s": 0},
}
#: M: the greedy sanity generation (prompt tokens, new tokens)
MOE_PROMPT, MOE_NEW_TOKENS = 64, 16


def set_compute_dtype(model, dtype) -> None:
    """Switch a built model's compute dtype in place (its config and every
    module's ``dtype``); the stored tensors are cast at use as before."""
    import torch

    cfg = model.cfg.replace(dtype=dtype)
    for module in model.modules():
        if hasattr(module, "cfg"):
            module.cfg = cfg
        if isinstance(getattr(module, "dtype", None), torch.dtype):
            module.dtype = dtype


def cached_vs_oracle(model, tokens, prompt_len: int) -> float:
    """The cached path teacher-forced on ``tokens`` (1, P + N) against the
    uncached oracle: max over the N steps of max |diff| / max |logit| of the
    next-token logits (the reference's ``test_cached_logits_match_oracle``
    on the card's shapes)."""
    import torch
    from finetune_controller_tpu_torch.models.llama import DenseKV

    n = tokens.shape[1] - prompt_len
    kv = DenseKV.zeros(model.cfg, 1, tokens.shape[1], model.device)
    dev = tokens.device
    worst = 0.0
    with torch.no_grad():
        for i in range(n):
            t = prompt_len + i
            if i == 0:
                cached = model.forward_cached(
                    tokens[:, :t], torch.arange(t, device=dev)[None], kv,
                    torch.zeros((1,), dtype=torch.int32, device=dev), fresh=True,
                    last_idx=t - 1)
            else:
                cached = model.forward_cached(
                    tokens[:, t - 1:t], torch.full((1, 1), t - 1, device=dev), kv,
                    torch.full((1,), t - 1, dtype=torch.int32, device=dev), last_idx=0)
            oracle = model(tokens[:, :t])[:, -1]
            worst = max(worst, ((cached.float() - oracle.float()).abs().max()
                                / oracle.float().abs().max()).item())
    return worst


def int4_digest(model) -> tuple:
    """A digest of a model's int4 buffers (the sums of each packed kernel's
    bytes and of its scales): equal digests, the same draw."""
    import torch

    return tuple((name, int(t.to(torch.int64).sum()) if t.dtype == torch.uint8
                  else float(t.double().sum()))
                 for name, t in model.named_buffers() if name.endswith(("_packed", "_scales")))


def moe_step_breakdown(prof, wall_s: float) -> dict:
    """Device ms of one profiled step by part: the experts' batched products
    (``aten::bmm``), the other products (``aten::mm``), int4 dequantization,
    routing and dispatch (the ``record_function`` ranges of
    ``models/quant.py`` and ``models/moe.py``), and the flash kernels."""
    from torch.autograd import DeviceType

    def device_us(evt):
        us = getattr(evt, "device_time_total", None)
        return us if us is not None else getattr(evt, "cuda_time_total", 0.0)

    parts = dict.fromkeys(("experts_bmm", "other_mm", "int4_dequantize", "moe_route",
                           "moe_dispatch"), 0.0)
    names = {"aten::bmm": "experts_bmm", "aten::mm": "other_mm"}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            continue
        part = names.get(evt.key, evt.key)
        if part in parts:
            parts[part] += device_us(evt) / 1e3
    kernels = device_time_by_kernel(prof, wall_s)
    parts["flash"] = sum(ms for _, ms in kernels["flash"])
    return {"wall_ms": kernels["wall_ms"], "device_ms": kernels["device_ms"],
            "device_busy": kernels["device_busy"], "parts_ms": parts, "top": kernels["top"]}


def moe_phase(work, seed: int) -> dict:
    """M: ``MOE_SPEC`` through ``train.cli.main`` in this process, 4 steps
    then 2 resumed from the step-4 checkpoint, on T2's documents.  Every
    ``init_random_`` of the phase records a digest of the int4 base: the
    two runs and the model rebuilt after them must draw the same one.  The
    flash kernels' counts are zeroed just before the first run and read
    just after the second.  The rebuilt model with the step-6 tensors takes
    one more step under ``torch.profiler`` (:func:`moe_step_breakdown`).
    Then, in f32 compute, it generates ``MOE_NEW_TOKENS`` greedy tokens from
    a ``MOE_PROMPT``-token prompt with the uncached oracle, and the cached
    path teacher-forced on them gives its logits within ``LOGITS_REL_TOL``
    at a dropless capacity, as the reference's test holds them: drops
    depend on each call's token count, which differs between a one-token
    decode and a full recompute, and in bf16 the rounding of two attention
    paths flips near-tied expert choices of this random-init router, so f32
    keeps the check on the cache.
    ``cached_generate``'s free-running tokens are printed beside the
    oracle's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from finetune_controller_tpu_torch.models.generate import cached_generate, greedy_generate
    from finetune_controller_tpu_torch.models.safetensors_io import SafetensorsFile
    from finetune_controller_tpu_torch.ops.kernels import flash_attention as fa
    from finetune_controller_tpu_torch.train import cli
    from finetune_controller_tpu_torch.train import trainer as trainer_mod
    from finetune_controller_tpu_torch.train.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    spec = json.loads(json.dumps(MOE_SPEC))
    spec["training"]["seed"] = seed
    docs = work / "train.jsonl"
    if not docs.exists():
        write_documents(docs, seed)
    art = work / "moe_artifacts"
    shutil.rmtree(art, ignore_errors=True)
    spec["dataset"] = {"path": str(docs)}
    spec["artifacts_dir"] = str(art)
    model_cfg, train_cfg = cli.build_model_config(spec), cli.build_train_config(spec)
    spec_path = work / "moe_job.json"
    digests = []
    draw = trainer_mod.init_random_

    def recording_init(model, s):
        out = draw(model, s)
        digests.append(int4_digest(model))
        return out

    for name in FLASH_KERNELS:
        getattr(fa, name).launches = 0
    walls, peaks = [], []
    trainer_mod.init_random_ = recording_init
    try:
        with _Capture("finetune_controller_tpu_torch.train.trainer") as capture:
            for total in (4, 6):
                spec["training"]["total_steps"] = total
                spec_path.write_text(json.dumps(spec))
                if DEVICE == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                try:
                    rc = cli.main(["--spec", str(spec_path)] + DEVICE_ARGS)
                except Exception as e:
                    raise SmokeFailure(f"M: training CLI ({total} steps): "
                                       f"{type(e).__name__}: {e}") from e
                if DEVICE == "cuda":
                    torch.cuda.synchronize()
                    peaks.append(torch.cuda.max_memory_allocated() / 1e9)
                walls.append(time.perf_counter() - t0)
                if rc != 0:
                    raise SmokeFailure(f"M: training CLI returned {rc}")
                gc.collect()
                if DEVICE == "cuda":
                    torch.cuda.empty_cache()
        launches = {name: getattr(fa, name).launches for name in FLASH_KERNELS}
        trainer = trainer_mod.Trainer(model_cfg, train_cfg, device=None if DEVICE == "cuda"
                                      else DEVICE)
    finally:
        trainer_mod.init_random_ = draw
    rows = _rows(art / "metrics.csv")
    if [int(r["step"]) for r in rows] != list(range(1, 7)):
        raise SmokeFailure(f"M: metrics.csv steps {[r['step'] for r in rows]}")
    if not any("resumed from checkpoint step 4" in m for m in capture.messages):
        raise SmokeFailure("M: the second run did not resume from checkpoint step 4")
    losses = [float(r["loss"]) for r in rows]
    aux = [float(r["moe_aux"]) for r in rows]
    if not all(math.isfinite(x) for x in losses) or not all(
            math.isfinite(a) and a > 0 for a in aux):
        raise SmokeFailure(f"M: losses {losses}, moe_aux {aux}")
    if len(digests) != 3 or len(set(digests)) != 1:
        raise SmokeFailure(f"M: the int4 base drawn {len(digests)} times, "
                           f"{len(set(digests))} distinct draws")
    state = CheckpointManager(art / "checkpoints").restore(6)
    n_layers = model_cfg.n_layers
    n_b = sum(k.endswith(".lora_b") for k in state["trainable"])
    moved = sum(k.endswith(".lora_b") and v.abs().max().item() > 0
                for k, v in state["trainable"].items())
    if moved != n_b or n_b != n_layers * 4:
        raise SmokeFailure(f"M: {moved} of {n_b} LoRA B leaves moved off zero")
    if DEVICE == "cuda" and min(launches.values()) <= 0:
        raise SmokeFailure(f"M: flash kernels not launched on the main path: {launches}")
    adapter = SafetensorsFile(art / "adapter" / "adapter_model.safetensors")
    adapter_cfg = json.loads((art / "adapter" / "adapter_config.json").read_text())
    if (len(adapter.keys()), adapter_cfg["target_modules"]) != (
            n_layers * 4 * 2, ["k_proj", "o_proj", "q_proj", "v_proj"]) \
            or not (art / "done.txt").exists():
        raise SmokeFailure(f"M: adapter/ holds {len(adapter.keys())} tensors for "
                           f"{adapter_cfg['target_modules']}; done.txt "
                           f"{(art / 'done.txt').exists()}")
    del adapter
    trainer.load_state(state)
    del state
    base = int4_base_bytes(trainer.model)
    batch = next(cli.build_batches(spec, model_cfg, train_cfg))
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if DEVICE == "cuda" else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        trainer.step(batch)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    breakdown = moe_step_breakdown(prof, wall)
    del prof
    model = trainer.model.eval()
    set_compute_dtype(model, torch.float32)
    for layer in model.layers:  # dropless for the generation check
        layer.moe.capacity_factor = float(model_cfg.n_experts)
    rng = np.random.default_rng(seed + 11)
    prompt = torch.as_tensor(rng.integers(0, model_cfg.vocab_size, (1, MOE_PROMPT)),
                             device=model.device)
    t0 = time.perf_counter()
    forced = greedy_generate(model, prompt, max_new_tokens=MOE_NEW_TOKENS)
    greedy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cached = cached_generate(model, prompt, max_new_tokens=MOE_NEW_TOKENS)[0, MOE_PROMPT:]
    cached_s = time.perf_counter() - t0
    greedy = forced[0, MOE_PROMPT:]
    agree = next((i for i, (a, b) in enumerate(zip(greedy.tolist(), cached.tolist()))
                  if a != b), MOE_NEW_TOKENS)
    cached_rel = cached_vs_oracle(model, forced, MOE_PROMPT)
    if not (cached_rel <= LOGITS_REL_TOL
            and all(0 <= t < model_cfg.vocab_size for t in greedy.tolist())):
        raise SmokeFailure(f"M: cached vs uncached next-token logits rel {cached_rel:.4g} "
                           f"(tolerance {LOGITS_REL_TOL}); greedy {greedy.tolist()}")
    del trainer, model
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    tokens = train_cfg.batch_size * train_cfg.seq_len
    step_ms = [tokens / float(r["tokens_per_sec"]) * 1e3 for r in rows]
    steady = sorted(step_ms[1:4])
    median = steady[len(steady) // 2]
    record = {
        "preset": "mixtral-8x7b", "layers": n_layers, "steps": len(rows), "loss": losses,
        "moe_aux": aux, "ms_per_step": step_ms, "ms_per_step_median": median,
        "tokens_per_s_median": tokens / (median / 1e3), "peak_memory_gb": max(peaks or [0.0]),
        "peak_memory_gb_by_run": peaks, "wall_s": walls, "launches": launches,
        "lora_b_moved": moved, "base_bytes": base, "int4_draws_equal": len(digests),
        "greedy_tokens": greedy.tolist(), "cached_tokens": cached.tolist(),
        "tokens_agreeing": agree, "cached_logits_rel": cached_rel,
        "greedy_s": greedy_s, "cached_s": cached_s,
        "step_profile": breakdown, "artifacts_bytes": tree_bytes(art),
        "phase_s": time.perf_counter() - t_phase,
    }
    parts = breakdown["parts_ms"]
    log(f"M: {spec['model']['preset']}, int4 experts, {n_layers} layers, LoRA r16 on attention: losses "
        f"{[round(x, 4) for x in losses]}, moe_aux {[round(a, 4) for a in aux]}; "
        f"{[round(x) for x in step_ms]} ms/step, {median:.0f} ms median of steps 2-4, "
        f"{record['tokens_per_s_median']:.0f} tokens/s; peak memory {peaks} GB; int4 base "
        f"packed {base['packed'] / 1e9:.2f} GB + scales {base['scales'] / 1e9:.2f} GB + bf16 "
        f"tensors {base['float'] / 1e9:.2f} GB, drawn identically {len(digests)} times; flash "
        f"launches {launches}; f32 greedy {MOE_NEW_TOKENS} tokens ({greedy_s:.1f} s), cached path "
        f"teacher-forced logits rel {cached_rel:.4g} (tolerance {LOGITS_REL_TOL}), "
        f"cached_generate ({cached_s:.1f} s) agrees on the first {agree} tokens; "
        f"{record['phase_s']:.1f} s")
    log(f"M step profile: {breakdown['wall_ms']:.0f} ms wall, device "
        f"{breakdown['device_ms'] or 0:.0f} ms, busy {breakdown['device_busy'] or 0:.3f}; "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in parts.items()))
    for name, ms in breakdown["top"]:
        log(f"  {ms:9.3f} ms  {name}")
    return record


# ---------------------------------------------------------------------------
# V: LLaVA-1.5 (the vision tower, the projector and the image-prefix decoder)
# ---------------------------------------------------------------------------

#: V0: the LLaVA-1.5 decoder's attention at V2's microbatch: 2 rows of
#: [image; text] = 576 + 1472 positions, 32 query and 32 key/value heads
#: (no grouping), head dim 128, causal, no segment ids
LLAVA_FLASH_SHAPE = (2, 2048, 32, 32, 128)
#: V1: the preset of the HF LLaVA directory and its decoder layers (the
#: tower is whole): one layer, since the run's disk writes (45.0 GB after
#: V2, deleted files not counted) leave about 3 GB under the 45 GiB cap
LLAVA_HF_PRESET = "llava-1.5-7b"
LLAVA_HF_LAYERS = 1
#: V2: ``llava-1.5-7b`` through C's server.  ``seq_len`` 1472 of text and
#: the 576 patches of the image prefix make 2048 decoder positions,
#: LLaVA-1.5's ``model_max_length``; ``profile_steps`` 2 traces steps 3-4
LLAVA_MODEL = "llava-1.5-lora"
#: V2's decoder depth, set by an operator plugin (``LLAVA_CUT_PLUGIN``): the
#: run must end inside 1200 s on the slower card machines (32 until then)
LLAVA_LAYERS = 8
LLAVA_CUT_PLUGIN = '''"""``llava-1.5-lora`` with {layers} of its 32 decoder layers."""

from finetune_controller_tpu_torch.controller.examples import Llava15LoRA


class Llava15LoRA_Cut(Llava15LoRA):
    def build_trainer_spec(self, job_id, artifacts_dir, **kw):
        spec = super().build_trainer_spec(job_id, artifacts_dir, **kw)
        spec["model"].setdefault("overrides", {{}})["n_layers"] = {layers}
        return spec
'''
LLAVA_ARGS = {"lora_rank": 16, "batch_size": 4, "seq_len": 1472, "grad_accum_steps": 2,
              "total_steps": 6, "checkpoint_every": 6, "log_every": 1, "profile_steps": 2,
              "warmup_steps": 2, "learning_rate": 2e-4}
#: V2: image-bearing rows uploaded with ``POST /datasets``, and their
#: images' side (CLIP ViT-L/14-336's input: no resize)
LLAVA_ROWS = 32
LLAVA_IMAGE = 336
#: V3: greedy tokens generated from V2's artifacts, and the prompt length
LLAVA_NEW_TOKENS = 8
LLAVA_PROMPT = 32
#: what ``POST /jobs/{id}/generate`` answers for a multimodal job: the
#: reference loader's refusal (its ``serve/loader.py:175-176``), status 409
MM_SERVE_REFUSAL = (409, "serving multimodal checkpoints is not supported yet")


def flash_shape_bench(shape, reps: int, seed: int, tag: str) -> dict:
    """The three flash kernels at ``shape`` = (B, S, H, Hkv, D) (bf16,
    causal, no segment ids) against their plain versions, each launched
    twice for the same bits, and timed beside the plain version, SDPA
    (``is_causal``, K/V repeated to every head under GQA) as the library
    yardstick and the bound (every causal pair, each input read once and
    each output written once): V0 at the LLaVA decoder's shape, P0 at the
    DPO step's stacked pairs."""
    import torch
    import torch.nn.functional as F
    from finetune_controller_tpu_torch.ops.kernels import flash_attention as fa
    from finetune_controller_tpu_torch.ops.kernels.timing import cuda_time_ms

    b, s, h, hkv, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, dout, _, _ = flash_inputs(gen, b, s, h, hkv, d, torch.bfloat16, segments=False)
    errs = flash_compare(q, k, v, dout, None, None, None, True)
    out, lse = fa.flash_forward_reference(q, k, v, None, None, True)
    delta = fa.flash_delta(out, dout)
    ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_() for x in
                  (q, k.repeat_interleave(h // hkv, 2), v.repeat_interleave(h // hkv, 2)))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_err = (lib_out.transpose(1, 2).float() - out.float()).abs().max().item()
    if lib_err > 0.1:
        raise AssertionError(f"{tag}: the library yardstick disagrees with plain by {lib_err}")
    variants = flash_variants(
        q, k, v, dout, lse, delta, None,
        lambda i: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True),
        lib_out, dout.transpose(1, 2))
    assert_flash_deterministic(q, k, v, dout, lse, delta, None, f"{tag}: ")
    pairs = b * s * (s + 1) / 2  # every causal (query, key) pair of each row
    nbytes = flash_bytes(q, k, None)
    rows = {}
    for name, (kern, plain, lib) in variants.items():
        ms = cuda_time_ms(kern, reps)
        flops = FLASH_OPS_PER_PAIR[name] * h * d * pairs
        bytes_ms = nbytes[name] / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / BF16_FLOPS * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        rows[name] = dict(
            ms=ms, plain_ms=cuda_time_ms(plain, max(2, reps // 4)),
            library_ms=cuda_time_ms(lib, reps), max_abs_err=errs[name], bound_ms=bound_ms,
            bound_by="bytes" if bytes_ms >= flops_ms else "operations",
            tflops=flops / (ms * 1e-3) / 1e12, bound_share=bound_ms / ms)
    return rows


def llava_hf_tensors(cfg) -> list[tuple[str, tuple, str | None, str]]:
    """The tensors of an HF LLaVA checkpoint for ``cfg`` in the layout of
    ``llava-hf/llava-1.5-7b-hf`` (``LlavaForConditionalGeneration``: the
    decoder under ``language_model.``, the whole CLIP tower under
    ``vision_tower.vision_model.``, the projector under
    ``multi_modal_projector.``): ``(name, shape, port key or None, how the
    port stores it)``, ``"T"`` transposed, ``"view"`` reshaped, ``""`` as
    it is; ``None`` for the tower layers and post norm that
    ``feature_layer=-2`` never runs."""
    t, vc = cfg.text, cfg.vision
    d, f, hd = t.d_model, t.d_ff, t.head_dim
    out = [("language_model.model.embed_tokens.weight", (t.vocab_size, d),
            "embed_tokens.embedding", "")]
    for i in range(t.n_layers):
        hf, port = f"language_model.model.layers.{i}.", f"layers.{i}."
        for p, shape in (("q_proj", (t.n_heads * hd, d)), ("k_proj", (t.n_kv_heads * hd, d)),
                         ("v_proj", (t.n_kv_heads * hd, d)), ("o_proj", (d, t.n_heads * hd))):
            out.append((f"{hf}self_attn.{p}.weight", shape, f"{port}attn.{p}.kernel", "T"))
        for p, shape in (("gate_proj", (f, d)), ("up_proj", (f, d)), ("down_proj", (d, f))):
            out.append((f"{hf}mlp.{p}.weight", shape, f"{port}mlp.{p}.kernel", "T"))
        out += [(f"{hf}input_layernorm.weight", (d,), f"{port}attn_norm.scale", ""),
                (f"{hf}post_attention_layernorm.weight", (d,), f"{port}mlp_norm.scale", "")]
    out += [("language_model.model.norm.weight", (d,), "final_norm.scale", ""),
            ("language_model.lm_head.weight", (t.vocab_size, d), "lm_head.kernel", "T")]
    v, vt, p = "vision_tower.vision_model.", "vision_tower.", vc.patch_size
    dv = vc.d_model
    out += [(f"{v}embeddings.class_embedding", (dv,), f"{vt}cls", "view"),
            (f"{v}embeddings.patch_embedding.weight", (dv, 3, p, p), f"{vt}patch_embed.kernel",
             ""),
            (f"{v}embeddings.position_embedding.weight", (vc.n_patches + 1, dv),
             f"{vt}pos_embed", "view"),
            (f"{v}pre_layrnorm.weight", (dv,), f"{vt}pre_norm.scale", ""),
            (f"{v}pre_layrnorm.bias", (dv,), f"{vt}pre_norm.bias", "")]
    for i in range(vc.n_layers):
        hf = f"{v}encoder.layers.{i}."
        port = f"{vt}blocks.{i}." if i < vc.n_run else None
        key = (lambda leaf: port + leaf) if port else (lambda leaf: None)
        for nm, leaf in (("k_proj", "key"), ("v_proj", "value"), ("q_proj", "query"),
                         ("out_proj", "out")):
            out += [(f"{hf}self_attn.{nm}.weight", (dv, dv), key(f"attn.{leaf}.kernel"), "T"),
                    (f"{hf}self_attn.{nm}.bias", (dv,), key(f"attn.{leaf}.bias"), "")]
        for ln in ("1", "2"):
            out += [(f"{hf}layer_norm{ln}.weight", (dv,), key(f"ln{ln}.scale"), ""),
                    (f"{hf}layer_norm{ln}.bias", (dv,), key(f"ln{ln}.bias"), "")]
        out += [(f"{hf}mlp.fc1.weight", (vc.d_ff, dv), key("fc1.kernel"), "T"),
                (f"{hf}mlp.fc1.bias", (vc.d_ff,), key("fc1.bias"), ""),
                (f"{hf}mlp.fc2.weight", (dv, vc.d_ff), key("fc2.kernel"), "T"),
                (f"{hf}mlp.fc2.bias", (dv,), key("fc2.bias"), "")]
    out += [(f"{v}post_layernorm.weight", (dv,), None, ""),
            (f"{v}post_layernorm.bias", (dv,), None, ""),
            ("multi_modal_projector.linear_1.weight", (cfg.projector_hidden, dv),
             "projector_fc1.kernel", "T"),
            ("multi_modal_projector.linear_1.bias", (cfg.projector_hidden,),
             "projector_fc1.bias", ""),
            ("multi_modal_projector.linear_2.weight", (d, cfg.projector_hidden),
             "projector_fc2.kernel", "T"),
            ("multi_modal_projector.linear_2.bias", (d,), "projector_fc2.bias", "")]
    return out


def llava_hf_phase(work, seed: int) -> dict:
    """V1: an HF LLaVA directory in the layout of ``llava-hf/llava-1.5-7b-hf``
    (f16, as that repository ships it; ``model-00001-of-00001.safetensors``,
    the index and ``config.json``) with the CLIP tower whole (24 layers and
    the post norm) and ``LLAVA_HF_LAYERS`` decoder layers, every tensor drawn
    on the card from ``seed``.  Read back onto the card through
    ``load_llava_params`` and held against the written tensors, bit for
    bit; the tower's last layer and post norm must be skipped."""
    import torch
    from finetune_controller_tpu_torch.models.hf_import import load_llava_params
    from finetune_controller_tpu_torch.models.multimodal import MM_PRESETS
    from finetune_controller_tpu_torch.models.safetensors_io import INDEX_FILENAME, StreamWriter

    cfg = MM_PRESETS[LLAVA_HF_PRESET].replace(n_layers=LLAVA_HF_LAYERS)
    out = Path(work) / "llava_hf"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    spec = llava_hf_tensors(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    written = {name: (torch.randn(shape, generator=gen, device=DEVICE) * 0.02).to(torch.float16)
               for name, shape, _, _ in spec}
    shard = "model-00001-of-00001.safetensors"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with StreamWriter(out / shard, [(n, torch.float16, s) for n, s, _, _ in spec],
                      {"format": "pt"}) as writer:
        for name, _, _, _ in spec:
            writer.write(name, written[name].to("cpu"))
    (out / INDEX_FILENAME).write_text(json.dumps({
        "metadata": {"total_size": writer.nbytes}, "weight_map": {n: shard for n, *_ in spec}}))
    t, vc = cfg.text, cfg.vision
    (out / "config.json").write_text(json.dumps({
        "architectures": ["LlavaForConditionalGeneration"], "model_type": "llava",
        "ignore_index": -100, "image_token_index": 32000, "projector_hidden_act": "gelu",
        "vision_feature_layer": vc.feature_layer, "vision_feature_select_strategy": "default",
        "torch_dtype": "float16",
        "text_config": {"model_type": "llama", "vocab_size": t.vocab_size,
                        "hidden_size": t.d_model, "intermediate_size": t.d_ff,
                        "num_hidden_layers": t.n_layers, "num_attention_heads": t.n_heads,
                        "num_key_value_heads": t.n_kv_heads,
                        "max_position_embeddings": t.max_seq_len, "rms_norm_eps": t.rms_eps},
        "vision_config": {"model_type": "clip_vision_model", "hidden_size": vc.d_model,
                          "intermediate_size": vc.d_ff, "num_hidden_layers": vc.n_layers,
                          "num_attention_heads": vc.n_heads, "image_size": vc.image_size,
                          "patch_size": vc.patch_size, "hidden_act": "quick_gelu",
                          "projection_dim": 768}}, indent=2))
    write_s = time.perf_counter() - t0
    nbytes = (out / shard).stat().st_size
    t0 = time.perf_counter()
    loaded = load_llava_params(out, cfg, dtype=torch.float16, device=DEVICE)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    want = {}
    for name, _, key, how in spec:
        if key is not None:
            x = written[name]
            want[key] = x.T if how == "T" else x.reshape(loaded[key].shape) if how == "view" else x
    diff = sorted(set(want) ^ set(loaded)) + [k for k in want if k in loaded and not (
        loaded[k].dtype == want[k].dtype and torch.equal(loaded[k], want[k]))]
    if diff:
        raise SmokeFailure(f"V1: {len(diff)} tensors read back differ from the written ones, "
                           f"first {diff[:3]}")
    skipped = sum(1 for _, _, key, _ in spec if key is None)
    del written, loaded, want
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    summary = {"decoder_layers": t.n_layers, "of_layers": MM_PRESETS[LLAVA_HF_PRESET].text.n_layers,
               "tower_layers": vc.n_layers, "tensors": len(spec), "skipped": skipped,
               "bytes": nbytes, "write_s": write_s, "write_gb_per_s": nbytes / write_s / 1e9,
               "read_s": read_s, "read_gb_per_s": nbytes / read_s / 1e9}
    log(f"V1: wrote an HF LLaVA directory (CLIP tower of {vc.n_layers} layers and post norm, "
        f"{t.n_layers} of {summary['of_layers']} decoder layers, f16, {nbytes / 1e9:.2f} GB) in {write_s:.1f} s "
        f"({summary['write_gb_per_s']:.2f} GB/s); load_llava_params read it onto the card in "
        f"{read_s:.1f} s ({summary['read_gb_per_s']:.2f} GB/s), every tensor bit-equal to the "
        f"writer's, the {skipped} tensors of the unused tower layer and post norm skipped")
    return summary


def write_mm_documents(path, seed: int, n: int, size: int) -> None:
    """``n`` image-bearing SFT rows: a seeded ``size``x``size``x3 uint8 image
    as an NPY ``data:`` URI (decoded and resized without PIL), a short prompt
    and a completion of 1400-1800 random-text bytes (the byte tokenizer's
    tokens; rows past ``seq_len`` truncate)."""
    import base64
    import io

    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
    with open(path, "w") as f:
        for i in range(n):
            buf = io.BytesIO()
            np.save(buf, rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
            chars = letters[rng.integers(0, 26, int(rng.integers(1400, 1801)))]
            chars[rng.random(len(chars)) < 0.17] = ord(" ")
            f.write(json.dumps({
                "image": "data:application/octet-stream;base64,"
                         + base64.b64encode(buf.getvalue()).decode(),
                "prompt": f"Describe picture {i}: ", "completion": chars.tobytes().decode(),
            }) + "\n")


def range_device_share(events: list, name: str) -> float | None:
    """The share of a profile's kernel time that runs inside the device
    spans (``gpu_user_annotation``) of the ``record_function`` range
    ``name``; ``None`` when the trace has no device spans of it."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "gpu_user_annotation" and e.get("name") == name)
    kernels = [(e["ts"], e["dur"]) for e in events if e.get("cat") == "kernel"]
    total = sum(dur for _, dur in kernels)
    if not spans or not total:
        return None
    inside = sum(dur for ts, dur in kernels
                 if any(a <= ts and ts + dur <= b for a, b in spans))
    return inside / total


def _llava_job(ctx, seed: int) -> dict:
    """V2: ``LLAVA_MODEL`` on C's server: ``LLAVA_ROWS`` image rows
    uploaded with ``POST /datasets``, the job through SUCCEEDED, its
    profile, exports and promotion, and ``/generate`` refused."""
    import importlib.util

    from finetune_controller_tpu_torch.models.safetensors_io import SafetensorsFile
    from finetune_controller_tpu_torch.train import cli

    api, scrape, rt, settings, on_loop, ctrl = ctx
    pil = importlib.util.find_spec("PIL") is not None
    docs = ctrl / "llava.jsonl"
    write_mm_documents(docs, seed, LLAVA_ROWS, LLAVA_IMAGE)
    dataset = api.ok("POST", "/datasets", files={"file": ("llava.jsonl", docs.read_bytes())},
                     want=(201,))
    t_submit = time.time()
    with CardMemorySampler() as memory:
        job_id = api.ok("POST", "/jobs", fields={
            "model_name": LLAVA_MODEL, "device": CONTROL_FLAVOR,
            "dataset_id": dataset["dataset_id"], "arguments": json.dumps(LLAVA_ARGS)})["job_id"]
        job, seen, logs = _follow_job(api, job_id, t_submit, "V2")
    order = [st for st in ("queued", "running", "succeeded") if st in seen]
    if order != ["queued", "running", "succeeded"]:
        raise SmokeFailure(f"V2: statuses seen {order}")
    records = _job_rows(api, job_id, LLAVA_ARGS["total_steps"], "V2")
    _, at = _timeline(api, job_id, ("submitted", "running", "train-started",
                                    "checkpoint-committed", "profile-captured",
                                    "train-finished", "succeeded"), "V2")
    art = settings.state_path / "sandboxes" / job_id / "artifacts"
    cfg = cli.build_model_config(json.loads((art / "resolved_config.json").read_text()))
    adapter = SafetensorsFile(art / "adapter" / "adapter_model.safetensors")
    projector = SafetensorsFile(art / "adapter" / "projector.safetensors")
    bad = [k for k in adapter.keys()
           if not k.startswith("base_model.model.language_model.model.layers.")]
    shapes = {k: tuple(projector.shape(k)) for k in projector.keys()}
    hidden, d = cfg.projector_hidden, cfg.text.d_model
    want = {"multi_modal_projector.linear_1.weight": (hidden, cfg.vision.d_model),
            "multi_modal_projector.linear_1.bias": (hidden,),
            "multi_modal_projector.linear_2.weight": (d, hidden),
            "multi_modal_projector.linear_2.bias": (d,)}
    if bad or len(adapter.keys()) != cfg.text.n_layers * 7 * 2 or shapes != want:
        raise SmokeFailure(f"V2: adapter keys off the language_model prefix {bad[:3]} "
                           f"({len(adapter.keys())} tensors), projector {shapes}")
    profiles = sorted((art / "profile").glob("steps_*.pt.trace.json"))
    if not profiles:
        raise SmokeFailure(f"V2: the job wrote no profile/ trace under {art}")
    events = json.loads(profiles[0].read_text()).get("traceEvents", [])
    kernel_names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    launches = {name: sum(sym in k for k in kernel_names)
                for name, sym in FLASH_KERNEL_SYMBOLS.items()}
    ranges = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    missing = [n for n in FLASH_KERNELS if launches[n] <= 0] + [
        r for r in ("vision_tower", "mm_projector") if r not in ranges]
    if DEVICE == "cuda" and missing:
        raise SmokeFailure(f"V2: the job's profile lacks {missing} "
                           f"({len(kernel_names)} kernel events)")
    shares = {r: range_device_share(events, r) for r in ("vision_tower", "mm_projector")}
    m = re.fullmatch(r"steps_(\d+)-(\d+)\.pt\.trace\.json", profiles[0].name)
    profiled = list(range(int(m.group(1)) + 1, int(m.group(2)) + 1))
    text_tokens = LLAVA_ARGS["batch_size"] * LLAVA_ARGS["seq_len"]
    step_ms = [text_tokens / r["tokens_per_sec"] * 1e3 for r in records]
    steady = sorted(ms for r, ms in zip(records, step_ms)
                    if r["step"] > 1 and r["step"] not in profiled)
    median = steady[len(steady) // 2]
    promote_s = _promote(api, job_id, "V2")
    status, answer = api.call("POST", f"/jobs/{job_id}/generate",
                              {"tokens": [1, 2, 3], "max_new_tokens": 2})
    if (status, answer) != (MM_SERVE_REFUSAL[0], {"detail": MM_SERVE_REFUSAL[1]}):
        raise SmokeFailure(f"V2: /generate answered {status} {answer}, not the reference's "
                           f"multimodal refusal")
    decoder_tokens = LLAVA_ARGS["batch_size"] * (LLAVA_ARGS["seq_len"] + cfg.vision.n_patches)
    record = {
        "job_id": job_id, "model": LLAVA_MODEL, "device": CONTROL_FLAVOR, "statuses": order,
        "pil_on_card": pil, "rows": LLAVA_ROWS, "dataset_bytes": docs.stat().st_size,
        "losses": [r["loss"] for r in records],
        "submit_to_running_s": seen["running"] - t_submit,
        "submit_to_first_step_s": records[0]["timestamp"] - at["submitted"],
        "ms_per_step": step_ms, "profiled_steps": profiled, "ms_per_step_median": median,
        "text_tokens_per_s_median": text_tokens / (median / 1e3),
        "decoder_tokens_per_s_median": decoder_tokens / (median / 1e3),
        "job_peak_memory_gb": memory.peak_gb, "flash_launches_in_profile": launches,
        "device_share": shares, "promote_s": promote_s,
        "generate_answer": [status, answer["detail"]],
        "artifacts": str(art), "log_lines": len(logs),
        "job_sandbox_bytes": tree_bytes(settings.state_path / "sandboxes" / job_id),
    }
    share = {r: "not measured" if x is None else f"{x:.4f}" for r, x in shares.items()}
    log(f"V2: {LLAVA_MODEL} on {CONTROL_FLAVOR} through the port's server ({LLAVA_ROWS} rows of "
        f"{LLAVA_IMAGE}x{LLAVA_IMAGE} NPY images, {docs.stat().st_size / 1e6:.1f} MB; PIL on the card: {pil}): "
        f"{' -> '.join(order)}; submit -> first step {record['submit_to_first_step_s']:.1f} s; "
        f"steps {[round(x) for x in step_ms]} ms (steps {profiled} profiled), {median:.0f} ms/step "
        f"median, {record['text_tokens_per_s_median']:.0f} text tokens/s "
        f"({record['decoder_tokens_per_s_median']:.0f} decoder positions/s); losses "
        f"{[round(x, 4) for x in record['losses']]}; the job's peak card memory (nvidia-smi, "
        f"above the value at submit) "
        f"{memory.peak_gb if memory.peak_gb is None else round(memory.peak_gb, 2)} GB; device "
        f"time share: vision_tower {share['vision_tower']}, mm_projector {share['mm_projector']}; "
        f"flash launches in the profile {launches}; promote {promote_s:.2f} s; /generate "
        f"answered {status} {answer['detail']!r}")
    return record


#: P1: ``llama3-8b-dpo`` through C's server at full width and C's depth (the
#: API spec's f32 base from the job's seed): the preset's batch of 8 pairs x
#: 512 tokens in 2 microbatches (one (2b, S) = (8, 512) stacked forward per
#: model each), 6 steps, evaluation every 3 steps on the held-out file (2
#: batches), a profiler window over steps 3-4
DPO_MODEL = "llama3-8b-dpo"
DPO_ARGS = {"lora_rank": 16, "batch_size": 8, "seq_len": 512, "grad_accum_steps": 2,
            "total_steps": 6, "checkpoint_every": 6, "log_every": 1, "profile_steps": 2,
            "eval_every": 3, "eval_steps": 2, "warmup_steps": 2, "learning_rate": 2e-4,
            "beta": 0.1}
#: P1: pre-tokenized preference rows uploaded with ``POST /datasets`` and
#: the held-out rows; prompt and completion lengths are drawn so most pairs
#: are right-padded to 512 and some are truncated
DPO_ROWS, DPO_EVAL_ROWS = 64, 16
LLAMA3_VOCAB = 128256
#: P1: the API names no held-out file (the reference's neither); an
#: operator plugin (the registry's plugin directory) renders ``llama3-8b-dpo``
#: with the held-out file as ``dataset.eval_path``
DPO_PLUGIN = '''"""``llama3-8b-dpo`` at {layers} of its 32 layers, whose trainer spec names a
held-out preference file."""

from finetune_controller_tpu_torch.controller.examples import Llama3_8B_DPO


class Llama3_8B_DPO_HeldOut(Llama3_8B_DPO):
    def build_trainer_spec(self, job_id, artifacts_dir, **kw):
        spec = super().build_trainer_spec(job_id, artifacts_dir, **kw)
        spec["dataset"]["eval_path"] = {eval_path!r}
        spec["model"].setdefault("overrides", {{}})["n_layers"] = {layers}
        return spec
'''


def write_preference_rows(path, seed: int, n: int, vocab: int) -> None:
    """``n`` pre-tokenized ``{prompt_tokens, chosen_tokens, rejected_tokens}``
    rows: prompts of 16-300 tokens, completions of 8-320."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            row = {"prompt_tokens": rng.integers(0, vocab, int(rng.integers(16, 301))).tolist()}
            for side in ("chosen_tokens", "rejected_tokens"):
                row[side] = rng.integers(0, vocab, int(rng.integers(8, 321))).tolist()
            f.write(json.dumps(row) + "\n")


def preference_rows(work, seed: int) -> tuple[Path, Path]:
    """P1's uploaded rows and held-out rows under ``work`` (written once;
    P0 and P2 read them too)."""
    train, held_out = Path(work) / "prefs.jsonl", Path(work) / "prefs_eval.jsonl"
    if not train.exists():
        write_preference_rows(train, seed + 11, DPO_ROWS, LLAMA3_VOCAB)
        write_preference_rows(held_out, seed + 12, DPO_EVAL_ROWS, LLAMA3_VOCAB)
    return train, held_out


def kernels_inside(events, range_name: str, symbol: str) -> int:
    """Launches of kernels named ``*symbol*`` inside the device spans
    (``gpu_user_annotation``) of the ``record_function`` range ``range_name``."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "gpu_user_annotation" and e.get("name") == range_name]
    return sum(1 for e in events if e.get("cat") == "kernel" and symbol in e.get("name", "")
               and any(a <= e["ts"] and e["ts"] + e["dur"] <= b for a, b in spans))


def _dpo_job(ctx, dataset_id: str, seed: int) -> dict:
    """P1: ``DPO_MODEL`` on C's server through SUCCEEDED (the
    ``ftc_dpo_reward_margin`` gauge scraped from ``/metrics`` while it
    runs), its rows, profile, adapter, promotion and ``/generate``.

    The profile proves the reference forward runs the flash kernel: with
    ``mlp`` remat an SFT step launches the forward twice per dQ launch (the
    forward and its recompute), so the forward launches of steps 3-4, less
    those inside ``evaluate`` (step 3's held-out pass), must exceed twice
    the dQ launches by exactly layers x microbatches x 2 steps."""
    api, scrape, rt, settings, on_loop, ctrl = ctx
    t_submit = time.time()
    job_id = api.ok("POST", "/jobs", fields={
        "model_name": DPO_MODEL, "device": CONTROL_FLAVOR, "dataset_id": dataset_id,
        "arguments": json.dumps(DPO_ARGS)})["job_id"]
    gauges = []

    def scrape_gauge(job):
        if job["status"] == "running" and not gauges:
            gauges.extend(float(line.rsplit(" ", 1)[1])
                          for line in scrape.ok("GET", "/metrics", raw=True).splitlines()
                          if line.startswith(f'ftc_dpo_reward_margin{{job_id="{job_id}"'))

    job, seen, logs = _follow_job(api, job_id, t_submit, "P1", on_poll=scrape_gauge)
    gauge = gauges[0] if gauges else None
    order = [st for st in ("queued", "running", "succeeded") if st in seen]
    records = _job_rows(api, job_id, DPO_ARGS["total_steps"], "P1")
    _, at = _timeline(api, job_id, ("submitted", "running", "train-started",
                                    "checkpoint-committed", "profile-captured",
                                    "train-finished", "succeeded"), "P1")
    for r in records:
        keys = ["reward_margin", "dpo_accuracy"] + (
            ["eval_reward_margin", "eval_dpo_accuracy"] if r["step"] % 3 == 0 else [])
        bad = [k for k in keys if not (isinstance(r.get(k), float) and math.isfinite(r[k]))]
        if bad:
            raise SmokeFailure(f"P1: step {r['step']} lacks finite {bad}: {r}")
    if gauge is None or not math.isfinite(gauge):
        raise SmokeFailure(f"P1: /metrics carried no ftc_dpo_reward_margin for {job_id} "
                           "while it ran")
    listing = {a["path"] for a in api.ok("GET", f"/jobs/{job_id}/artifacts?list=1")["artifacts"]}
    if "adapter/adapter_model.safetensors" not in listing:
        raise SmokeFailure(f"P1: no exported adapter in {sorted(listing)[:20]}")
    profiles = sorted(p for p in listing if p.startswith("profile/") and p.endswith(".json"))
    if not profiles:
        raise SmokeFailure("P1: the job's artifacts hold no profile/ trace")
    events = json.loads(on_loop(rt.store.get_bytes(
        f"{job['artifacts_uri']}/{profiles[0]}"), 300)).get("traceEvents", [])
    kernel_names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    launches = {name: sum(sym in k for k in kernel_names)
                for name, sym in FLASH_KERNEL_SYMBOLS.items()}
    fwd_sym = FLASH_KERNEL_SYMBOLS["flash_forward"]
    in_eval = kernels_inside(events, "evaluate", fwd_sym)
    in_ref = kernels_inside(events, "dpo_reference_forward", fwd_sym)
    m = re.fullmatch(r"profile/steps_(\d+)-(\d+)\.pt\.trace\.json", profiles[0])
    profiled = list(range(int(m.group(1)) + 1, int(m.group(2)) + 1))
    layers, micro = C_LAYERS, DPO_ARGS["grad_accum_steps"]
    excess = launches["flash_forward"] - in_eval - 2 * launches["flash_backward_dq"]
    want = layers * micro * len(profiled)
    if DEVICE == "cuda" and (excess != want or launches["flash_backward_dq"] != want):
        raise SmokeFailure(
            f"P1: forward launches {launches['flash_forward']} in steps {profiled}, "
            f"{in_eval} of them in evaluate, dQ {launches['flash_backward_dq']}: the excess "
            f"over the SFT ratio is {excess}, not the reference forward's {want}")
    tokens = DPO_ARGS["batch_size"] * DPO_ARGS["seq_len"]
    step_ms = [tokens / r["tokens_per_sec"] * 1e3 for r in records]
    steady = sorted(ms for r, ms in zip(records, step_ms)
                    if r["step"] > 1 and r["step"] not in profiled)
    median = steady[len(steady) // 2]
    promote_s, load_s, meta = _promote_and_load(api, job_id, "P1")
    served = _generate_against_engine(ctx, job_id, meta["vocab_size"], CONTROL_PROMPTS,
                                      CONTROL_NEW_TOKENS, seed + 2, "p")
    record = {
        "job_id": job_id, "model": DPO_MODEL, "device": CONTROL_FLAVOR, "statuses": order,
        "losses": [r["loss"] for r in records],
        "reward_margin": [r["reward_margin"] for r in records],
        "dpo_accuracy": [r["dpo_accuracy"] for r in records],
        "eval_reward_margin": [r["eval_reward_margin"] for r in records if r["step"] % 3 == 0],
        "eval_dpo_accuracy": [r["eval_dpo_accuracy"] for r in records if r["step"] % 3 == 0],
        "gauge_reward_margin_while_running": gauge,
        "submit_to_running_s": seen["running"] - t_submit,
        "submit_to_first_step_s": records[0]["timestamp"] - at["submitted"],
        "ms_per_step": step_ms, "profiled_steps": profiled, "ms_per_step_median": median,
        "positions_per_s_median": 2 * tokens / (median / 1e3),
        "flash_launches_in_profile": launches, "forward_launches_in_evaluate": in_eval,
        "forward_launches_in_reference_ranges": in_ref,
        "forward_excess_over_sft_ratio": excess, "reference_forward_launches_expected": want,
        "promote_s": promote_s, "model_load_s": load_s, "lora_merged": meta["lora_merged"],
        **{k: served[k] for k in ("ttft_s", "decode_tokens_per_s", "requests_ok", "requests",
                                  "generated_tokens", "paged_launches")},
        "log_lines": len(logs),
        "job_sandbox_bytes": tree_bytes(settings.state_path / "sandboxes" / job_id),
    }
    log(f"P1: {DPO_MODEL} on {CONTROL_FLAVOR} through the port's server ({DPO_ROWS} uploaded "
        f"pairs, {DPO_EVAL_ROWS} held out): {' -> '.join(order)}; submit -> first step "
        f"{record['submit_to_first_step_s']:.1f} s; steps {[round(x) for x in step_ms]} ms "
        f"(steps {profiled} profiled), {median:.0f} ms/step median, "
        f"{record['positions_per_s_median']:.0f} positions/s (chosen + rejected); losses "
        f"{[round(x, 4) for x in record['losses']]}; reward_margin "
        f"{[round(x, 4) for x in record['reward_margin']]}; eval_dpo_accuracy "
        f"{record['eval_dpo_accuracy']}; ftc_dpo_reward_margin while running {gauge:.4g}; "
        f"flash launches in the profile {launches}: forward {launches['flash_forward']} = "
        f"2 x dQ {launches['flash_backward_dq']} (the SFT ratio) + {in_eval} in evaluate + "
        f"{excess} (the reference forward: {layers} layers x {micro} microbatches x "
        f"{len(profiled)} steps = {want}); {in_ref} forward launches inside "
        f"dpo_reference_forward ranges; promote {promote_s:.2f} s, load {load_s:.1f} s; TTFT "
        f"{served['ttft_s'] * 1e3:.1f} ms, {served['decode_tokens_per_s']:.1f} generated "
        f"tokens/s, {served['requests_ok']}/{served['requests']} equal to the in-process engine; "
        f"paged launches {served['paged_launches']}")
    return record


# ---------------------------------------------------------------------------
# P: the preference plane (DPO objective, reward model, RLHF-lite loop)
# ---------------------------------------------------------------------------

#: P0: the DPO step's flash shape: 8 pairs stacked to 16 rows of 512
DPO_FLASH_SHAPE = (16, 512, 32, 8, 128)
#: P2 and P3: llama3-8b at full width cut to this depth (P1 runs at C's);
#: at 32 layers P2's and P3's checkpoints with optimizer state (0.5 GB each,
#: 5 of them) and exports would add ~3 GB to the run's writes, and P3's
#: learner steps and actor decode would take ~4x longer
PREF_LAYERS = 8
#: P2/P3 job specs (``train.cli.main`` in this process, bf16 base)
PREF_TRAINING = {"frozen_dtype": "bfloat16", "batch_size": 8, "seq_len": 512,
                 "warmup_steps": 1, "learning_rate": 2e-4, "log_every": 1,
                 "checkpoint_every": 2, "heartbeat_interval_s": 0}
#: P3: the actor's engine: 4 decode lanes, 16 new tokens a candidate, 16
#: prompts (32 candidates) a round, the learner's batch once 16 pairs are in
RLHF_ROLLOUT = {"slots": 4, "max_new_tokens": 16, "pairs_per_round": 16, "min_fill": 16}


def dpo_objective_check(rows, seed: int) -> dict:
    """P0: the DPO objective of llama3-8b cut to 2 layers (full width, rank
    16, bf16 base, non-zero B) on the first batch of 8 pairs x 512 of
    ``rows`` (right-padded, no segment ids), with ``FTC_FLASH_ATTN=kernel``
    against ``plain``: the four per-sequence logprob vectors (policy and
    reference, chosen and rejected) within ``MODEL_LOSS_REL_TOL`` of the
    largest, the LoRA gradients within ``MODEL_GRAD_REL_TOL`` of each leaf's
    largest (T3's bounds), the forward kernel's lse finite on every row,
    padded positions included, and the kernel path's loss within
    ``DPO_LOSS_F32_REL_TOL`` of the plain path run in f32 (the same bf16
    weights cast at use).  The bf16 plain path's loss is printed beside it
    and not bounded: the margin is beta x the difference of sequence sums
    of ~300 token logprobs of ~-12 nats each, so the bf16 rounding that
    T3's mean loss averages away survives in it (on an NVIDIA H100 80GB
    HBM3 at 700 W the two bf16 losses differed by 1.03e-2 of themselves
    while the kernel path was 1.11e-3 off the f32 one)."""
    import torch
    from finetune_controller_tpu_torch.data.preference import preference_jsonl_batches
    from finetune_controller_tpu_torch.models.llama import PRESETS
    from finetune_controller_tpu_torch.models.lora import LoRAConfig
    from finetune_controller_tpu_torch.ops.kernels import flash_attention as fa
    from finetune_controller_tpu_torch.prefs.dpo_trainer import DPOTrainer
    from finetune_controller_tpu_torch.prefs.losses import dpo_loss
    from finetune_controller_tpu_torch.train.trainer import TrainConfig

    cfg = PRESETS["llama3-8b"].replace(n_layers=2, lora=LoRAConfig(rank=16, alpha=32.0))
    trainer = DPOTrainer(cfg, TrainConfig(task="dpo", frozen_dtype="bfloat16", batch_size=8,
                                          seq_len=512, seed=seed, dpo_beta=0.1), device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    with torch.no_grad():  # non-zero B: the policy leaves the reference
        for name, p in trainer.trainable.items():
            if name.endswith(".lora_b"):
                p.normal_(0.0, 0.02, generator=gen)
    batch = trainer._to_device(next(preference_jsonl_batches(str(rows), 8, 512, seed=seed)))
    # a row is right-padded where its completion stops short of the last position
    padded = int((batch["chosen_mask"][:, -1] == 0).sum()
                 + (batch["rejected_mask"][:, -1] == 0).sum())
    lse_finite = []
    kernel_fwd = fa.flash_forward

    def checked_forward(*a, **kw):
        out, lse = kernel_fwd(*a, **kw)
        lse_finite.append(bool(torch.isfinite(lse).all()))
        return out, lse

    out = {}
    fa.flash_forward = checked_forward
    try:
        for impl, dtype in (("kernel", cfg.dtype), ("plain", cfg.dtype),
                            ("plain", torch.float32)):
            os.environ["FTC_FLASH_ATTN"] = impl
            set_compute_dtype(trainer.model, dtype)
            for name in FLASH_KERNELS:
                getattr(fa, name).launches = 0
            pc, pr = trainer._pair_logprobs(batch)
            rc, rr = trainer.reference_logprobs(batch)
            loss, metrics = dpo_loss(pc, pr, rc, rr, trainer.cfg.dpo_beta)
            lps = torch.stack([pc.detach(), pr.detach(), rc, rr])
            grads = None
            if dtype != torch.float32:
                loss.backward()
                grads = {n: p.grad.float() for n, p in trainer.trainable.items()}
            out[f"{impl}_{str(dtype).removeprefix('torch.')}"] = (
                loss.item(), float(metrics["reward_margin"]), lps, grads,
                {name: getattr(fa, name).launches for name in FLASH_KERNELS})
            for p in trainer.trainable.values():
                p.grad = None
    finally:
        fa.flash_forward = kernel_fwd
        os.environ.pop("FTC_FLASH_ATTN", None)
        set_compute_dtype(trainer.model, cfg.dtype)
    (lk, mk, sk, gk, nk), (lp, mp, sp, gp, _) = out["kernel_bfloat16"], out["plain_bfloat16"]
    l32, m32, s32, _, _ = out["plain_float32"]
    lp_rel = ((sk - sp).abs().max() / sp.abs().max()).item()
    grad_rel = max(((gk[n] - gp[n]).abs().max() / gp[n].abs().max()).item() for n in gp)
    if DEVICE == "cuda" and (min(nk.values()) <= 0 or not lse_finite or not all(lse_finite)):
        raise SmokeFailure(f"P0: kernel launches {nk}, lse finite per forward {lse_finite}")
    loss_rel_f32 = abs(lk - l32) / abs(l32)
    if not (math.isfinite(lk) and lp_rel <= MODEL_LOSS_REL_TOL
            and grad_rel <= MODEL_GRAD_REL_TOL and loss_rel_f32 <= DPO_LOSS_F32_REL_TOL):
        raise SmokeFailure(f"P0: sequence logprobs rel {lp_rel:.3g}, worst LoRA grad rel "
                           f"{grad_rel:.3g}, loss rel to the f32 plain path {loss_rel_f32:.3g} "
                           f"(tolerances {MODEL_LOSS_REL_TOL}, {MODEL_GRAD_REL_TOL}, "
                           f"{DPO_LOSS_F32_REL_TOL}); loss {lk} vs {lp}, f32 {l32}")
    del trainer
    return {"loss_kernel": lk, "loss_plain": lp, "loss_plain_f32": l32,
            "loss_rel": abs(lk - lp) / abs(lp), "loss_rel_kernel_vs_f32": loss_rel_f32,
            "loss_rel_kernel_vs_f32_tolerance": DPO_LOSS_F32_REL_TOL,
            "loss_rel_plain_vs_f32": abs(lp - l32) / l32,
            "margin_kernel": mk, "margin_plain": mp, "margin_plain_f32": m32,
            "seq_logprob_rel": lp_rel,
            "seq_logprob_abs_err": (sk - sp).abs().max().item(),
            "seq_logprob_abs_err_kernel_vs_f32": (sk - s32).abs().max().item(),
            "seq_logprob_abs_err_plain_vs_f32": (sp - s32).abs().max().item(),
            "grad_rel": grad_rel, "kernel_launches": nk,
            "lse_finite_forwards": len(lse_finite), "padded_rows": padded}


def _pref_spec(work, task: str, seed: int, **training) -> dict:
    return {"job_id": f"chip-smoke-{task}", "model": {
        "preset": "llama3-8b", "lora": {"rank": 16, "alpha": 32.0},
        "overrides": {"n_layers": PREF_LAYERS}},
        "training": {**PREF_TRAINING, "task": task, "seed": seed, **training},
        "artifacts_dir": str(Path(work) / task / "artifacts")}


def _run_cli(spec: dict) -> tuple[float, list[dict]]:
    """``train.cli.main`` on ``spec`` in this process: (seconds, rows)."""
    from finetune_controller_tpu_torch.train import cli

    art = Path(spec["artifacts_dir"])
    shutil.rmtree(art.parent, ignore_errors=True)
    art.mkdir(parents=True)
    path = art.parent / "spec.json"
    path.write_text(json.dumps(spec))
    t0 = time.perf_counter()
    if cli.main(["--spec", str(path), *DEVICE_ARGS]) != 0:
        raise SmokeFailure(f"{spec['job_id']}: the CLI failed")
    return time.perf_counter() - t0, _rows(art / "metrics.csv")


def reward_phase(work, rows, eval_rows, seed: int) -> dict:
    """P2: a Bradley–Terry reward model of llama3-8b (``PREF_LAYERS`` deep)
    through ``train.cli.main`` on P1's uploaded rows (4 steps, evaluation
    every 2 on the held-out rows).  Before the run, the job's step-0 trainer
    (the same seed) scores the first batch through the flash kernels, and
    each score must equal the mean completion logprob the plain path gives
    (``MODEL_LOSS_REL_TOL`` of the largest).  After it: finite ``bt_accuracy``,
    ``reward_head.msgpack`` read back by the port's reader (``w`` of the
    vocabulary's width), and the job's directory served by the loader with
    the head left out."""
    import torch
    from finetune_controller_tpu_torch.ops.kernels import flash_attention as fa
    from finetune_controller_tpu_torch.prefs.dpo_trainer import stack_pairs
    from finetune_controller_tpu_torch.prefs.losses import masked_sequence_logprobs
    from finetune_controller_tpu_torch.prefs.reward_trainer import read_reward_head
    from finetune_controller_tpu_torch.serve.loader import load_serving_model
    from finetune_controller_tpu_torch.train import cli

    spec = _pref_spec(work, "reward", seed, total_steps=4, eval_every=2, eval_steps=2)
    spec["dataset"] = {"path": str(rows), "eval_path": str(eval_rows)}
    model_cfg, train_cfg = cli.build_model_config(spec), cli.build_train_config(spec)
    trainer = cli.trainer_class("reward")(model_cfg, train_cfg, device=DEVICE)
    batch = trainer._to_device(next(cli.build_batches(spec, model_cfg, train_cfg)))
    try:
        with torch.no_grad():
            os.environ["FTC_FLASH_ATTN"] = "kernel"
            scores = trainer.scores(batch)
            os.environ["FTC_FLASH_ATTN"] = "plain"
            _, tokens, masks = stack_pairs(batch)
            mean_lp = masked_sequence_logprobs(trainer.model(tokens), tokens, masks) / \
                masks[:, 1:].sum(-1).clamp(min=1.0)
    finally:
        os.environ.pop("FTC_FLASH_ATTN", None)
    score_rel = ((scores - mean_lp).abs().max() / mean_lp.abs().max()).item()
    del trainer, batch
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    if score_rel > MODEL_LOSS_REL_TOL:
        raise SmokeFailure(f"P2: step-0 scores (kernel) vs mean completion logprob (plain): "
                           f"rel {score_rel:.3g} > {MODEL_LOSS_REL_TOL}")
    for name in FLASH_KERNELS:
        getattr(fa, name).launches = 0
    seconds, rows_out = _run_cli(spec)
    launches = {name: getattr(fa, name).launches for name in FLASH_KERNELS}
    art = Path(spec["artifacts_dir"])
    acc = [float(r["bt_accuracy"]) for r in rows_out]
    eval_acc = [float(r["eval_bt_accuracy"]) for r in rows_out if r.get("eval_bt_accuracy")]
    head = read_reward_head(str(art))
    shapes = {k: tuple(v.shape) for k, v in head.items()}
    if (len(rows_out) != 4 or not all(map(math.isfinite, acc + eval_acc)) or len(eval_acc) != 2
            or shapes != {"a": (), "w": (model_cfg.vocab_size,), "b": ()}):
        raise SmokeFailure(f"P2: bt_accuracy {acc}, eval {eval_acc}, head shapes {shapes}")
    if DEVICE == "cuda" and min(launches.values()) <= 0:
        raise SmokeFailure(f"P2: the flash kernels were not launched ({launches})")
    model, meta = load_serving_model(art, merge_lora=False, device=DEVICE)
    heads = [k for k in model.state_dict() if k.startswith("head")]
    if meta["task"] != "reward" or heads:
        raise SmokeFailure(f"P2: the loader served {meta} with head tensors {heads}")
    del model
    gc.collect()
    record = {"layers": PREF_LAYERS, "seconds": seconds, "step0_score_rel": score_rel,
              "losses": [float(r["loss"]) for r in rows_out], "bt_accuracy": acc,
              "eval_bt_accuracy": eval_acc, "head": {k: head[k].tolist() for k in ("a", "b")},
              "head_w_abs_max": float(head["w"].abs().max()), "flash_launches": launches,
              "loader_meta": meta, "artifacts_bytes": tree_bytes(art)}
    log(f"P2: reward model (llama3-8b, {PREF_LAYERS} layers, bf16 base) through "
        f"train.cli.main, 4 steps in {seconds:.1f} s: step-0 score vs mean completion "
        f"logprob rel {score_rel:.3g}; losses {[round(x, 4) for x in record['losses']]}; "
        f"bt_accuracy {acc}, eval {eval_acc}; head a {record['head']['a']:.5f}, b "
        f"{record['head']['b']:.5f}, max |w| {record['head_w_abs_max']:.3g} (w {shapes['w']}); "
        f"flash launches {launches}; loader: task {meta['task']}, step "
        f"{meta['checkpoint_step']}, head dropped")
    return record


def rlhf_phase(work, seed: int) -> dict:
    """P3: the in-process RLHF-lite loop through ``train.cli.main``:
    llama3-8b (``PREF_LAYERS`` deep, bf16 base), 6 learner steps, a checkpoint
    every 2, the actor's paged engine per ``RLHF_ROLLOUT``.  The actor is
    taken from ``build_rlhf_loop`` as the CLI builds it.  Checked: at least
    2 reloads, the learner's base digest unchanged by them, the paged kernel
    launched by the actor and the flash kernels by the learner (both counts
    zeroed before the run and read after)."""
    import torch
    from finetune_controller_tpu_torch.ops.kernels import flash_attention as fa
    from finetune_controller_tpu_torch.ops.kernels import paged_attention as pa
    from finetune_controller_tpu_torch.prefs import learner

    spec = _pref_spec(work, "rlhf", seed, total_steps=6)
    spec["rollout"] = dict(RLHF_ROLLOUT)
    built = {}
    build = learner.build_rlhf_loop

    def capture(trainer, artifacts_dir, **kw):
        stream, actor, buffer = build(trainer, artifacts_dir, **kw)
        built.update(trainer=trainer, actor=actor, buffer=buffer,
                     digest=base_digest(trainer.model, trainer.trainable))
        return stream, actor, buffer

    for name in FLASH_KERNELS:
        getattr(fa, name).launches = 0
    pa.paged_attention.launches = 0
    learner.build_rlhf_loop = capture
    try:
        seconds, rows_out = _run_cli(spec)
    finally:
        learner.build_rlhf_loop = build
    flash = {name: getattr(fa, name).launches for name in FLASH_KERNELS}
    paged = pa.paged_attention.launches
    trainer, actor, buffer = built["trainer"], built["actor"], built["buffer"]
    unchanged = base_digest(trainer.model, trainer.trainable) == built["digest"]
    versions = [int(float(r["actor_version"])) for r in rows_out]
    if actor.reloads < 2 or not unchanged or len(rows_out) != 6:
        raise SmokeFailure(f"P3: {actor.reloads} actor reloads, base unchanged {unchanged}, "
                           f"{len(rows_out)} rows")
    if DEVICE == "cuda" and (paged <= 0 or min(flash.values()) <= 0):
        raise SmokeFailure(f"P3: paged launches (actor) {paged}, flash launches (learner) "
                           f"{flash}")
    record = {
        "layers": PREF_LAYERS, "seconds": seconds, "rollout": RLHF_ROLLOUT,
        "losses": [float(r["loss"]) for r in rows_out],
        "reward_margin": [float(r["reward_margin"]) for r in rows_out],
        "actor_version": versions, "reloads": actor.reloads, "rounds": actor.rounds,
        "base_unchanged": unchanged, "buffer_depth": buffer.depth,
        "staleness": buffer.staleness, "buffer_pushed_total": buffer.pushed_total,
        "bootstrap_pairs": actor.bootstrap_pairs, "pairs_generated": actor.pairs_generated,
        "actor_tokens": actor.tokens_generated, "actor_generate_s": actor.generate_seconds,
        "actor_tokens_per_s": actor.tokens_per_sec, "paged_launches": paged,
        "learner_compute_ms_median": float(np.median(
            [float(r["phase_compute_ms"]) for r in rows_out[1:]])),
        "flash_launches": flash, "artifacts_bytes": tree_bytes(Path(spec["artifacts_dir"])),
    }
    del trainer, actor, buffer, built
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    log(f"P3: RLHF-lite (llama3-8b, {PREF_LAYERS} layers, bf16 base) through train.cli.main, "
        f"6 steps in {seconds:.1f} s: actor versions per row {versions}, {record['reloads']} "
        f"reloads over {record['rounds']} rounds, the learner's base digest unchanged; buffer "
        f"depth {record['buffer_depth']}, staleness {record['staleness']} checkpoints, "
        f"{record['buffer_pushed_total']} pairs pushed ({record['bootstrap_pairs']} oracle "
        f"bootstrap); actor {record['actor_tokens']} tokens in {record['actor_generate_s']:.1f} "
        f"s = {record['actor_tokens_per_s']:.1f} tokens/s; losses "
        f"{[round(x, 4) for x in record['losses']]}; paged launches (actor) {paged}, flash "
        f"launches (learner) {flash}")
    return record


# ---------------------------------------------------------------------------
# P4: the disaggregated rollout plane
# ---------------------------------------------------------------------------

#: P4: rollout worker processes beside the learner
P4_WORKERS = 2
#: P4's learner: the first commit (and so the first policy push) must come
#: after the SIGKILLed worker's respawn streams again (a respawn regenerates
#: version-0 rounds only before any push), so the learner's step
#: ``P4_CHECKPOINT_EVERY`` waits for that stream (at most
#: ``P4_RESPAWN_WAIT_S``; the respawn streamed 33.8-41.5 s after the kill on
#: an NVIDIA H100 80GB HBM3 at 700 W).  The second push follows a commit
#: later; the steps after it let the stream, which the prefetch thread runs
#: ahead, pull once more and push it
P4_CHECKPOINT_EVERY = 16
P4_TOTAL_STEPS = 2 * P4_CHECKPOINT_EVERY + 4
P4_RESPAWN_WAIT_S = 240.0
#: the reward worker's serving engine (it answers generate too; P4 drives
#: its reward_score RPC)
P4_REWARD_ENGINE = {"slots": 2, "prompt_buckets": (32,), "max_new_tokens": 8}
#: what P4 may write (its ``DiskTally``): the 8-layer rollout base (5.59 GB
#: in bf16), the learner's checkpoints, the workers' sandboxes
P4_DISK_BYTES = 7 * 2**30
#: how long P4 waits for the respawned worker and for rollout-0 to report
#: the last pushed policy before the learner's plane closes
P4_SETTLE_S = 120.0
#: re-scored pairs against the rewards they carry (the RPC's, not an oracle's)
P4_REWARD_REL_TOL = 0.02


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _sandbox_spawn_s(box: Path) -> float:
    """Spec written -> socket bound, from a worker sandbox's file times."""
    return (box / "transport.json").stat().st_mtime - (box / "worker_spec.json").stat().st_mtime


def rollout_plane_phase(work, seed: int, rlhf: dict) -> dict:
    """P4: P2's reward job served by one reward worker (``ReplicaFleet`` in
    process mode with ``reward_spec``, the service's path) on a port chosen
    up front, and beside its spawn ``task: rlhf`` through ``train.cli.main``
    with P3's spec, ``rollout_workers`` ``P4_WORKERS`` and
    ``rollout.reward_port`` at that worker (a rollout worker's reward client
    waits for it).  ``rollout-1``
    is SIGKILLed once its first round is ingested and before the learner's
    first commit, so its respawn regenerates version-0 rounds.  Checked: the
    rows; the respawn, no (worker, pair id) ingested twice, replays counted
    and token-equal to their originals; ``rollout-0``'s pid unchanged and its
    policy at the last pushed version; a ``rollout.round`` span overlapping a
    learner step; the RPC's scores in the pairs, no oracle pair; every
    kernel's launches in its process.  The phase's writes stay within
    ``P4_DISK_BYTES``."""
    import signal
    import threading

    import torch
    from finetune_controller_tpu_torch.ops.kernels import flash_attention as fa
    from finetune_controller_tpu_torch.prefs import rollout_plane as rp
    from finetune_controller_tpu_torch.prefs.dpo_trainer import DPOTrainer
    from finetune_controller_tpu_torch.serve.engine import EngineConfig
    from finetune_controller_tpu_torch.serve.fleet import ReplicaFleet
    from finetune_controller_tpu_torch.transport.process import ProcessTransport

    t_phase = time.perf_counter()
    disk0 = DISK.read()
    reward_art = Path(work) / "reward" / "artifacts"
    reward_root = Path(work) / "p4_reward"
    shutil.rmtree(reward_root, ignore_errors=True)
    loop = asyncio.new_event_loop()
    loop_thread = threading.Thread(target=loop.run_forever, name="p4-reward", daemon=True)
    loop_thread.start()

    def on_loop(coro, timeout=None):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    reward_port = _free_port()
    fleet = ReplicaFleet(
        "p4-reward", None, EngineConfig(**P4_REWARD_ENGINE), replicas=1,
        transport=ProcessTransport(
            job_id="p4-reward", root=reward_root, spawn_timeout_s=600.0, port_base=reward_port,
            payload={"builder": "deploy_dir",
                     "kwargs": {"dir": str(reward_art), "merge_lora": True, "device": DEVICE}}),
        reward_spec={"artifacts_dir": str(reward_art)})
    record: dict = {"layers": PREF_LAYERS, "workers": P4_WORKERS,
                    "total_steps": P4_TOTAL_STEPS, "checkpoint_every": P4_CHECKPOINT_EVERY}
    built: dict = {}
    seen: dict = {}
    replays: list = []
    ingested: list = []
    step_starts: list = []
    kill: dict = {}
    stop = threading.Event()
    real_build, real_ingest, real_from_doc = (rp.build_remote_rlhf_loop,
                                              rp.RolloutPlane._ingest, rp._pair_from_doc)
    real_step = DPOTrainer.step

    first_ingest: dict = {}

    def spy_ingest(plane, ws, doc):
        first_ingest.setdefault((ws.worker_id, ws.generation), time.time())
        for pd in doc.get("pairs") or []:
            first = seen.setdefault((ws.worker_id, pd["id"]), pd)
            if first is not pd:
                replays.append({"worker": ws.worker_id, "id": pd["id"], "gen": ws.generation,
                                "tokens_equal": all(first[k] == pd[k] for k in (
                                    "prompt", "chosen", "rejected", "version")),
                                "rewards_equal": all(first[k] == pd[k] for k in (
                                    "reward_chosen", "reward_rejected"))})
        if ws.worker_id == "rollout-0" and doc.get("pairs") and "first_round" not in built:
            built["first_round"] = doc
        return real_ingest(plane, ws, doc)

    def spy_from_doc(doc):
        # called for fresh pairs only, on the pulling worker's thread
        ingested.append((threading.current_thread().name.removeprefix("ftc-pull-"), doc["id"]))
        return real_from_doc(doc)

    def spy_step(trainer, batch):
        if len(step_starts) + 1 == P4_CHECKPOINT_EVERY:
            # the step whose commit is the first push: after the respawn streams
            deadline = time.monotonic() + P4_RESPAWN_WAIT_S
            while ("rollout-1", 2) not in first_ingest and time.monotonic() < deadline:
                time.sleep(0.02)
            kill["learner_waited_at_step"] = P4_CHECKPOINT_EVERY
        step_starts.append(time.time_ns())
        return real_step(trainer, batch)

    def killer(plane, art):
        """SIGKILL rollout-1 once its first round is in, then time its
        respawn until the new incarnation's first round is in."""
        ws = plane._workers[1]
        while not stop.is_set():
            if ws.generation == 1 and ws.cursor >= 1 and "ts" not in kill:
                kill.update(pid=ws.handle.pid, ts=time.time(),
                            commits=sorted(p.name for p in (art / "checkpoints").glob("step_*")
                                           if p.is_dir() and p.name[5:].isdigit()),
                            pushed=plane._policy is not None, learner_steps=len(step_starts))
                os.kill(kill["pid"], signal.SIGKILL)
            if "ts" in kill and ("rollout-1", 2) in first_ingest:
                kill["respawned_streaming_s"] = first_ingest[("rollout-1", 2)] - kill["ts"]
                kill["pushed_at_respawn"] = plane._policy is not None
                return
            time.sleep(0.005)

    def capture(trainer, artifacts_dir, **kw):
        t0 = time.perf_counter()
        stream, plane, buffer = real_build(trainer, artifacts_dir, **kw)
        built.update(plane=plane, build_s=time.perf_counter() - t0,
                     pid0=plane._workers[0].handle.pid)
        art = Path(artifacts_dir)
        threading.Thread(target=killer, args=(plane, art), daemon=True).start()
        real_close = plane.close

        def close():
            # before the workers go: wait (bounded) for the respawn to stream
            # and for rollout-0 to report the last pushed policy, then read
            # every worker's probe
            deadline = time.monotonic() + P4_SETTLE_S
            ws0, ws1 = plane._workers[0], plane._workers[1]
            while time.monotonic() < deadline and not (
                    "respawned_streaming_s" in kill and plane._policy is not None
                    and int(ws0.last_stats.get("actor_version", -1)) >= plane._policy[0]):
                time.sleep(0.05)
            built["card_used_gb"] = card_used_mb() / 1e3 if DEVICE == "cuda" else 0.0
            built["probes"] = {}
            for ws in plane._workers:
                try:
                    built["probes"][ws.worker_id] = plane._run(ws.handle.health_probe(), 60)
                # a dead worker's probe is a failed check below, not a crash
                except Exception as exc:  # noqa: BLE001
                    built["probes"][ws.worker_id] = {"error": repr(exc), "stats": {
                        "paged_launches": 0, "cuda_peak_bytes": 0}}
            built["pid0_end"], built["pid1_end"] = ws0.handle.pid, ws1.handle.pid
            built["last_stats"] = {ws.worker_id: dict(ws.last_stats) for ws in plane._workers}
            built["generations"] = {ws.worker_id: ws.generation for ws in plane._workers}
            built["policy_version"] = plane._policy[0] if plane._policy else None
            built["policy_blob_bytes"] = len(plane._policy[1]) if plane._policy else 0
            built["plane_stats"] = plane.stats()
            stop.set()
            real_close()

        plane.close = close
        return stream, plane, buffer

    try:
        reward_up = asyncio.run_coroutine_threadsafe(fleet.start(), loop)
        spec = _pref_spec(work, "rlhf", seed, total_steps=P4_TOTAL_STEPS,
                          checkpoint_every=P4_CHECKPOINT_EVERY, rollout_workers=P4_WORKERS)
        spec["job_id"] = "chip-smoke-rlhf-remote"
        spec["artifacts_dir"] = str(Path(work) / "p4_rlhf" / "artifacts")
        spec["rollout"] = {**RLHF_ROLLOUT, "reward_port": reward_port}
        for name in FLASH_KERNELS:
            getattr(fa, name).launches = 0
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        rp.build_remote_rlhf_loop, rp.RolloutPlane._ingest = capture, spy_ingest
        rp._pair_from_doc, DPOTrainer.step = spy_from_doc, spy_step
        try:
            seconds, rows = _run_cli(spec)
        finally:
            rp.build_remote_rlhf_loop, rp.RolloutPlane._ingest = real_build, real_ingest
            rp._pair_from_doc, DPOTrainer.step = real_from_doc, real_step
            stop.set()
        reward_up.result(900)
        reward_replica = fleet.replicas["r0"].batcher
        record["reward_worker_spawn_s"] = _sandbox_spawn_s(Path(reward_replica.sandbox))
        learner_flash = {name: getattr(fa, name).launches for name in FLASH_KERNELS}
        learner_peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
        reward_probe = on_loop(reward_replica.health_probe(), 120)
        # the first ingested round of rollout-0, re-scored: its pairs carry
        # the RPC's scores
        first = built["first_round"]["pairs"]
        items = [{"prompt": pd["prompt"], "completion": pd[side]}
                 for pd in first for side in ("chosen", "rejected")]
        t0 = time.perf_counter()
        rescored = on_loop(reward_replica.reward_score(items), 300)
        record["rescore_s"] = time.perf_counter() - t0
        carried = [pd[f"reward_{side}"] for pd in first for side in ("chosen", "rejected")]
        rescore_rel = max(abs(a - b) for a, b in zip(rescored, carried)) / max(
            abs(x) for x in carried)
    finally:
        rp.build_remote_rlhf_loop, rp.RolloutPlane._ingest = real_build, real_ingest
        rp._pair_from_doc, DPOTrainer.step = real_from_doc, real_step
        on_loop(fleet.close(), 120)
        loop.call_soon_threadsafe(loop.stop)
        loop_thread.join(30)
        loop.close()
    art = Path(spec["artifacts_dir"])
    probes, stats = built["probes"], built["last_stats"]
    paged = {w: int(p["stats"]["paged_launches"]) for w, p in probes.items()}
    reward_flash = reward_probe["stats"]["flash_launches"]
    spans = [json.loads(line) for line in (art / "trace" / "trainer.jsonl").read_text().splitlines()]
    rounds = [sp for sp in spans if sp["name"] == "rollout.round"
              and sp.get("attributes", {}).get("service") == "rollout"]
    intervals = list(zip(step_starts, step_starts[1:]))
    overlapping = sum(1 for sp in rounds if any(
        sp["start_ns"] < t1 and sp["end_ns"] > t0 for t0, t1 in intervals))
    plane_stats = built["plane_stats"]
    boxes = {p.name: _sandbox_spawn_s(p) for p in sorted((art / "rollout_workers").iterdir())
             if (p / "transport.json").exists()}
    tokens = {w: int(st.get("actor_tokens_generated", 0)) for w, st in stats.items()}
    gen_s = {w: float(st.get("actor_generate_seconds", 0.0)) for w, st in stats.items()}
    rpc_calls = sum(int(st.get("reward_score_calls", 0)) for st in stats.values())
    rpc_s = sum(float(st.get("reward_score_seconds", 0.0)) for st in stats.values())
    record.update({
        "seconds": seconds, "build_loop_s": built["build_s"], "rows": len(rows),
        "losses": [float(r["loss"]) for r in rows],
        "reward_margin": [float(r["reward_margin"]) for r in rows],
        "actor_version_rows": [int(float(r["actor_version"])) for r in rows],
        "worker_spawn_s": boxes, "kill": kill, "replays": len(replays),
        "replays_tokens_equal": sum(r["tokens_equal"] for r in replays),
        "replays_rewards_equal": sum(r["rewards_equal"] for r in replays),
        "ingested": len(ingested), "ingested_unique": len(set(ingested)),
        "plane": plane_stats, "pid0": built["pid0"], "pid0_end": built["pid0_end"],
        "generations": built["generations"], "last_pushed_version": built["policy_version"],
        "actor_version_by_worker": {w: int(st.get("actor_version", 0)) for w, st in stats.items()},
        "bootstrap_pairs_by_worker": {w: int(st.get("actor_bootstrap_pairs", -1))
                                      for w, st in stats.items()},
        "rollout_spans": len(rounds), "rollout_spans_overlapping_steps": overlapping,
        "actor_tokens_per_s_by_worker": {w: tokens[w] / max(gen_s[w], 1e-9) for w in tokens},
        "actor_tokens_per_s_sum": sum(tokens[w] / max(gen_s[w], 1e-9) for w in tokens),
        "p3_actor_tokens_per_s": rlhf["actor_tokens_per_s"],
        "learner_ms_per_step_median": float(np.median(np.diff(step_starts[1:]))) / 1e6,
        "learner_compute_ms_median": float(np.median(
            [float(r["phase_compute_ms"]) for r in rows[1:]])),
        "p3_learner_compute_ms_median": rlhf["learner_compute_ms_median"],
        "reward_score_calls": rpc_calls, "reward_score_ms_per_round": rpc_s / max(rpc_calls, 1) * 1e3,
        "reward_scored_total": int(reward_probe["stats"]["reward_scored_total"]),
        "rescore_rel": rescore_rel,
        "rollout_base_bytes": (art / "rollout_base" / "params.msgpack").stat().st_size,
        "policy_blob_bytes": built["policy_blob_bytes"],
        "peak_gb": {"learner": learner_peak / 1e9,
                    "reward": reward_probe["stats"]["cuda_peak_bytes"] / 1e9,
                    **{w: p["stats"]["cuda_peak_bytes"] / 1e9 for w, p in probes.items()}},
        "card_used_gb_before_close": built["card_used_gb"],
        "probe_errors": {w: p["error"] for w, p in probes.items() if "error" in p},
        "paged_launches": paged, "reward_flash_launches": reward_flash,
        "flash_launches": learner_flash,
    })
    written = DISK.written(disk0)
    record["bytes_written"] = written
    record["phase_s"] = time.perf_counter() - t_phase
    log(f"P4: remote RLHF (llama3-8b, {PREF_LAYERS} layers, bf16 base) through train.cli.main, "
        f"{P4_WORKERS} rollout workers scoring with P2's reward model served by a reward worker: "
        f"{len(rows)} steps in {seconds:.1f} s (plane up in {built['build_s']:.1f} s: rollout "
        f"base {record['rollout_base_bytes'] / 1e9:.2f} GB written, workers spawned together); "
        f"spawn s by worker sandbox { {k: round(v, 1) for k, v in boxes.items()} }, reward "
        f"worker {record['reward_worker_spawn_s']:.1f} s; rollout-1 SIGKILLed after its first "
        f"round at learner step {kill.get('learner_steps')} (commits before: "
        f"{kill.get('commits')}, policy pushed before: {kill.get('pushed')}), respawned and "
        f"streaming {kill.get('respawned_streaming_s', float('nan')):.1f} s later (a policy "
        f"pushed by then: {kill.get('pushed_at_respawn')}); {record['ingested']} pairs "
        f"ingested ({record['ingested_unique']} distinct (worker, id)), "
        f"{plane_stats['rollout_dup_pairs_total']} duplicates dropped, {len(replays)} replays "
        f"seen, {record['replays_tokens_equal']} token-equal to their originals "
        f"({record['replays_rewards_equal']} with equal rewards); rollout-0 pid "
        f"{built['pid0']} -> {built['pid0_end']}, actor versions by worker "
        f"{record['actor_version_by_worker']} (last pushed {built['policy_version']}, "
        f"{plane_stats['rollout_policy_pushes_total']} pushes); {overlapping} of {len(rounds)} "
        f"rollout.round spans overlap a learner step")
    log(f"P4 rates: actor tokens/s by worker "
        f"{ {k: round(v, 1) for k, v in record['actor_tokens_per_s_by_worker'].items()} }, "
        f"{record['actor_tokens_per_s_sum']:.1f} in all (P3 in process: "
        f"{rlhf['actor_tokens_per_s']:.1f}); learner {record['learner_ms_per_step_median']:.1f} "
        f"ms/step between step starts, compute {record['learner_compute_ms_median']:.1f} ms "
        f"(P3: {rlhf['learner_compute_ms_median']:.1f} ms); reward_score "
        f"{record['reward_score_ms_per_round']:.1f} ms a round over {rpc_calls} calls, "
        f"{record['reward_scored_total']} items scored, a round re-scored within rel "
        f"{rescore_rel:.3g}; policy blob {record['policy_blob_bytes'] / 1e6:.1f} MB; peak card "
        f"GB by process { {k: round(v, 2) for k, v in record['peak_gb'].items()} } (card "
        f"used before the close {record['card_used_gb_before_close']:.1f} GB); paged "
        f"launches by worker {paged}, flash by the reward worker {reward_flash}, by the learner "
        f"{learner_flash}; P4 wrote {written / 1e9:.2f} GB in {record['phase_s']:.1f} s")
    problems = []
    finite = all(map(math.isfinite, record["losses"] + record["reward_margin"]))
    if len(rows) != P4_TOTAL_STEPS or not finite:
        problems.append(f"{len(rows)} rows, finite loss and margin {finite}")
    if plane_stats["rollout_respawns_total"] < 1 or "respawned_streaming_s" not in kill:
        problems.append(f"respawns {plane_stats['rollout_respawns_total']}, kill {kill}")
    if kill.get("commits") or kill.get("pushed"):
        problems.append(f"the kill came after a commit or a push: {kill}")
    if len(ingested) != len(set(ingested)):
        problems.append("a (worker, pair id) was ingested twice")
    if plane_stats["rollout_dup_pairs_total"] <= 0 or not replays or not all(
            r["tokens_equal"] for r in replays):
        problems.append(f"duplicates {plane_stats['rollout_dup_pairs_total']}, replays "
                        f"{len(replays)}, token-equal {record['replays_tokens_equal']}")
    if built["pid0"] != built["pid0_end"] or built["policy_version"] is None or \
            plane_stats["rollout_policy_pushes_total"] < 2 or \
            record["actor_version_by_worker"]["rollout-0"] != built["policy_version"]:
        problems.append(f"rollover: pid {built['pid0']} -> {built['pid0_end']}, pushes "
                        f"{plane_stats['rollout_policy_pushes_total']}, rollout-0 at "
                        f"{record['actor_version_by_worker']['rollout-0']} of "
                        f"{built['policy_version']}")
    if overlapping < 1:
        problems.append(f"no rollout.round span ({len(rounds)}) overlaps a learner step")
    if record["reward_scored_total"] <= 0 or rpc_calls <= 0 or any(
            v != 0 for v in record["bootstrap_pairs_by_worker"].values()) or \
            rescore_rel > P4_REWARD_REL_TOL:
        problems.append(f"reward: scored {record['reward_scored_total']}, calls {rpc_calls}, "
                        f"bootstrap {record['bootstrap_pairs_by_worker']}, re-scored rel "
                        f"{rescore_rel:.3g}")
    if record["probe_errors"]:
        problems.append(f"worker probes failed: {record['probe_errors']}")
    if DEVICE == "cuda" and (min(paged.values()) <= 0 or reward_flash["flash_forward"] <= 0
                             or min(learner_flash.values()) <= 0):
        problems.append(f"kernels: paged {paged}, reward worker flash {reward_flash}, "
                        f"learner flash {learner_flash}")
    if written > P4_DISK_BYTES:
        problems.append(f"{written / 2**30:.2f} GiB written (budget "
                        f"{P4_DISK_BYTES / 2**30:.1f} GiB)")
    if problems:
        raise SmokeFailure("P4: " + "; ".join(problems))
    shutil.rmtree(reward_root, ignore_errors=True)
    return record


def base_digest(model, trained) -> dict:
    """{name: the sum of the bf16 bit patterns} of every parameter of
    ``model`` not in ``trained`` (the frozen base), each rounded to bf16
    first: the same seed's draw gives the same digest in f32 and in bf16."""
    import torch

    return {name: int(p.detach().to(torch.bfloat16).view(torch.int16).sum(dtype=torch.int64))
            for name, p in model.named_parameters() if name not in trained}


def llava_generate_phase(art, seed: int) -> dict:
    """V3: ``generate_cli --image`` on V2's artifacts, cached and
    ``--oracle``, ``LLAVA_NEW_TOKENS`` greedy tokens each: equal tokens.  The
    model the CLI rebuilds (``load_trained_model``, through the trainer)
    is kept from the cached run: its base digest must equal that of the
    job's own trainer rebuilt from the spec (f32, drawn from the seed), and
    ``cached_generate`` on it is timed (TTFT: the fill and the first token;
    tokens/s: the decode steps after it)."""
    import contextlib
    import io

    import torch
    from finetune_controller_tpu_torch.data.images import preprocess_image
    from finetune_controller_tpu_torch.models import generate_cli
    from finetune_controller_tpu_torch.models.generate import cached_generate
    from finetune_controller_tpu_torch.serve import loader
    from finetune_controller_tpu_torch.train import cli
    from finetune_controller_tpu_torch.train.trainer import Trainer

    art = Path(art)
    rng = np.random.default_rng(seed + 9)
    image = art.parent / "v3_image.npy"
    np.save(image, rng.integers(0, 256, (400, 300, 3), dtype=np.uint8))
    prompt = rng.integers(0, 256, LLAVA_PROMPT).tolist()
    argv = ["--artifacts", str(art), "--prompt-tokens", ",".join(map(str, prompt)),
            "--image", str(image), "--max-new-tokens", str(LLAVA_NEW_TOKENS)] + DEVICE_ARGS
    built = []
    real = loader.load_trained_model

    def keep(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]

    outs, wall = [], []
    for extra in ([], ["--oracle"]):
        buf = io.StringIO()
        loader.load_trained_model = keep
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = generate_cli.main(argv + extra)
        finally:
            loader.load_trained_model = real
        wall.append(time.perf_counter() - t0)
        if rc != 0:
            raise SmokeFailure(f"V3: generate_cli {' '.join(extra)} exited {rc}")
        outs.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
        if not extra:  # keep the cached run's model; drop the oracle's
            model, meta = built[0]
            with open(art / "resolved_config.json") as f:
                spec = json.load(f)
            cfg = cli.build_model_config(spec)
            trained = {k for k, _ in model.named_parameters()
                       if k.endswith((".lora_a", ".lora_b")) or k.startswith("projector_fc")}
            rebuilt = base_digest(model, trained)
            pixels = torch.from_numpy(preprocess_image(str(image), cfg.image_size))[None]
            tokens = torch.tensor([prompt])
            timed = {}
            for n in (1, LLAVA_NEW_TOKENS):
                cached_generate(model, tokens, max_new_tokens=n, pixels=pixels)  # warm
                if DEVICE == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                cached_generate(model, tokens, max_new_tokens=n, pixels=pixels)
                if DEVICE == "cuda":
                    torch.cuda.synchronize()
                timed[n] = time.perf_counter() - t0
            del model, built[:]
            gc.collect()
            if DEVICE == "cuda":
                torch.cuda.empty_cache()
        else:
            built.clear()
            gc.collect()
            if DEVICE == "cuda":
                torch.cuda.empty_cache()
    if outs[0]["new_tokens"] != outs[1]["new_tokens"] or len(outs[0]["new_tokens"]) != \
            LLAVA_NEW_TOKENS:
        raise SmokeFailure(f"V3: cached tokens {outs[0]['new_tokens']} vs the oracle's "
                           f"{outs[1]['new_tokens']}")
    trainer = Trainer(cfg, cli.build_train_config(spec), device=DEVICE)
    drawn = base_digest(trainer.model, set(trainer.trainable))
    del trainer
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    if drawn != rebuilt:
        differ = sorted(k for k in drawn if drawn[k] != rebuilt.get(k))
        raise SmokeFailure(f"V3: the rebuilt base differs from the trainer's draw on "
                           f"{len(differ)} tensors, first {differ[:3]}")
    ttft = timed[1]
    rate = (LLAVA_NEW_TOKENS - 1) / (timed[LLAVA_NEW_TOKENS] - timed[1])
    record = {"tokens": outs[0]["new_tokens"], "checkpoint_step": outs[0]["checkpoint_step"],
              "cli_s": wall, "ttft_s": ttft, "decode_tokens_per_s": rate,
              "prompt_tokens": LLAVA_PROMPT, "image_prefix": cfg.vision.n_patches,
              "base_tensors_digested": len(drawn)}
    log(f"V3: generate_cli --image on V2's artifacts (step {record['checkpoint_step']}): "
        f"cached and --oracle give the same {LLAVA_NEW_TOKENS} greedy tokens "
        f"{record['tokens']} ({wall[0]:.1f} s and {wall[1]:.1f} s a call, rebuild included); "
        f"the rebuilt bf16 base equals the job trainer's f32 draw rounded to bf16 on all "
        f"{len(drawn)} base tensors; cached_generate over {cfg.vision.n_patches} image + "
        f"{LLAVA_PROMPT} prompt tokens: TTFT {ttft * 1e3:.1f} ms, {rate:.1f} tokens/s")
    return record


#: R: resilience at full width — C's job with a checkpoint every 2 steps and
#: no profiler window, submitted through ``ftc-ctl`` and SIGKILLed after step
#: ``RESILIENCE_KILL_AT``; the server's retry budget lets the supervisor
#: resubmit it once, the backend restarts nothing itself
RESILIENCE_ARGS = {**{k: v for k, v in CONTROL_ARGS.items() if k != "profile_steps"},
                   "checkpoint_every": 2}
RESILIENCE_KILL_AT = 3
RESILIENCE_ENV = {**CONTROL_ENV, "FTC_RETRY_MAX_ATTEMPTS": "2",
                  "FTC_RETRY_BASE_DELAY_S": "0.5", "FTC_RETRY_MAX_DELAY_S": "1"}
#: R: |R's loss - C's loss| / |C's loss| at each step (the same seed, data
#: and kernels: bit-equal is expected)
RESILIENCE_LOSS_REL_TOL = 1e-4
#: R: the phase's bytes written, at most
RESILIENCE_DISK_BYTES = 4 * 2**30
#: R: tokens a step
RESILIENCE_TOKENS = RESILIENCE_ARGS["batch_size"] * RESILIENCE_ARGS["seq_len"]


def resume_outcome(logs: list[str], step2_mtime: float, kill_ts: float) -> tuple[int, str]:
    """R: the step the second attempt must resume from, and why.  The
    SIGKILL after step 3 may land inside step 2's asynchronous save, as the
    reference's own SIGKILL test allows.  ``step2_mtime`` is the mtime of
    the committed ``step_2/manifest.json`` (written inside the staging, so
    older than the commit), ``kill_ts`` that of the once-file the hook
    writes just before the kill.  Older: the save committed before the
    kill, so the second attempt resumes from step 2 and sweeps nothing.
    Newer: the second attempt saved step 2 again, so the kill caught the
    save in flight, and the second attempt sweeps its staging
    (``step_2.tmp``) and starts from step 0.  Raises ``SmokeFailure`` when
    the logs say otherwise."""
    resumed = [int(m.group(1)) for ln in logs
               for m in [re.search(r"resumed from checkpoint step (\d+)", ln)] if m]
    swept = [ln for ln in logs if "swept stale uncommitted checkpoint staging step_2.tmp" in ln]
    if step2_mtime < kill_ts:
        step, why, ok = 2, "step 2's async save committed before the kill", (
            resumed == [2] and not swept)
    else:
        step, why, ok = 0, "the kill landed inside step 2's async save", (
            resumed == [] and len(swept) == 1)
    if not ok:
        raise SmokeFailure(f"R: {why}, so the second attempt must resume from step {step}"
                           f"{' and sweep step_2.tmp' if step == 0 else ''}; resumed from "
                           f"{resumed}, swept {swept}")
    return step, why


def attempt_launches(events: list[dict]) -> list[dict]:
    """R: the flash launches of each attempt's trainer, in order: the
    ``kernel_launches`` of its last event that carries them (its process's
    counts so far); attempts begin at ``train-started``."""
    out: list[dict] = []
    for e in events:
        if e["event"] == "train-started":
            out.append({})
        elif out and e["attrs"].get("kernel_launches"):
            out[-1] = dict(e["attrs"]["kernel_launches"])
    return out


def save_cost(records: list[dict], checkpoint_ms: dict, resumed_from: int) -> dict:
    """R: what the last attempt's asynchronous saves cost against its
    blocking last save.  The rows past ``resumed_from`` are the last
    attempt's, and its first is a warm-up.  The row after an asynchronous
    save ran while the writer thread serialized it; the others ran with no
    writer.  An asynchronous save costs its span (snapshot and handoff)
    plus its next step's compute above the median of the writer-free
    steps; a blocking save costs its span (snapshot and write)."""
    compute = {int(r["step"]): r.get("phase_compute_ms") for r in records}
    if any(v is None for v in compute.values()):
        return {"not measured": "no phase_compute_ms column"}
    saves = {k: v for k, v in checkpoint_ms.items() if k > resumed_from}
    overlapped = {k + 1 for k, v in saves.items() if not v["blocking"]}
    free = [k for k in compute if k > resumed_from + 1 and k not in overlapped]
    base = float(np.median([compute[k] for k in free]))
    out = {"writer_free_steps": free, "writer_free_compute_ms": base, "async": {},
           "blocking": {}}
    for k, v in sorted(saves.items()):
        if v["blocking"]:
            out["blocking"][k] = {"span_ms": v["ms"], "snapshot_ms": v["snapshot_ms"]}
        elif k + 1 in compute:
            extra = compute[k + 1] - base
            out["async"][k] = {"span_ms": v["ms"], "snapshot_ms": v["snapshot_ms"],
                               "next_step_extra_ms": extra, "total_ms": v["ms"] + extra}
    return out


def resilience_phase(work, seed: int, control: dict) -> dict:
    """R: a ``llama3-8b-lora`` job at full width and C's depth submitted with
    ``python -m finetune_controller_tpu_torch.controller.ctl submit ...
    --watch`` (a subprocess) to the port's server in this process, with C's
    arguments, dataset and seed, a checkpoint every 2 steps and no profiler
    window.  The local backend's ``extra_env`` arms the trainer's chaos hook:
    ``StepFault(kill_at_step=3, SIGKILL)`` with its once-file in the job's
    sandbox (the trainer's working directory), the backend's own restart
    budget is 0 and the retry supervisor's 2 attempts, so recovery runs
    through the supervisor.  Checked: RUNNING -> RETRYING -> RUNNING ->
    SUCCEEDED, one ``attempt_history`` entry of class ``infra`` (exit -9),
    the second attempt's start as :func:`resume_outcome` derives it (from
    step 2 when step 2's async save committed before the kill, else from
    step 0 after sweeping its staging), exactly 6 metrics rows (replayed
    rows not doubled), a ``manifest.json`` in every committed step whose
    leaves are the saved state's, no staging left and the object store
    holding the committed steps only, every flash kernel launched by each
    attempt's steps (the trainer's ``kernel_launches``
    events), each step's loss within ``RESILIENCE_LOSS_REL_TOL`` of C's,
    and the phase's writes within ``RESILIENCE_DISK_BYTES``.  Printed: the
    saves' spans and writer times and :func:`save_cost`.  Then (R2)
    :func:`snapshot_check`."""
    import csv
    import signal

    import torch
    from finetune_controller_tpu_torch.resilience import StepFault
    from finetune_controller_tpu_torch.train.checkpoint import MANIFEST_NAME, CheckpointManager
    from finetune_controller_tpu_torch.train.elastic import leaf_entries

    t_phase = time.perf_counter()
    disk0 = DISK.written()
    ctrl = Path(__file__).resolve().parent / "build" / "chip_smoke_resilience"
    shutil.rmtree(ctrl, ignore_errors=True)
    ctrl.mkdir(parents=True)
    docs = Path(work) / "train.jsonl"
    fault = StepFault(kill_at_step=RESILIENCE_KILL_AT, signum=signal.SIGKILL,
                      once_file="fault_fired")
    (ctrl / "plugins").mkdir()
    (ctrl / "plugins" / "llama_depth.py").write_text(LLAMA_CUT_PLUGIN.format(layers=C_LAYERS))
    with control_plane(ctrl, RESILIENCE_ENV, plugin_dir=ctrl / "plugins") as ctx:
        api, scrape, rt, settings, on_loop, _ = ctx
        rt.backend.backoff_limit = 0
        rt.backend.extra_env.update(fault.to_env())
        dataset = api.ok("POST", "/datasets", files={"file": ("train.jsonl", docs.read_bytes())},
                         want=(201,))
        argv = [sys.executable, "-m", "finetune_controller_tpu_torch.controller.ctl",
                "--api", api.base.rsplit("/api/v1", 1)[0], "--token", api.token,
                "submit", CONTROL_MODEL, "--device", CONTROL_FLAVOR,
                "--dataset-id", dataset["dataset_id"], "--watch"]
        for k, v in RESILIENCE_ARGS.items():
            argv += ["--arg", f"{k}={json.dumps(v)}"]
        t_submit = time.time()
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, cwd=Path(__file__).resolve().parent)
        try:
            head = []
            for line in proc.stdout:  # the submit answer, printed before the watch
                head.append(line)
                if line.rstrip() == "}":
                    break
            job_id = json.loads("".join(head))["job_id"]
            transitions = []
            while time.time() - t_submit < CONTROL_JOB_TIMEOUT_S:
                job = api.ok("GET", f"/jobs/{job_id}")
                if not transitions or transitions[-1][0] != job["status"]:
                    transitions.append((job["status"], time.time()))
                if job["status"] in ("succeeded", "failed", "cancelled"):
                    break
                time.sleep(0.25)
            out, err = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        statuses = [st for st, _ in transitions]
        logs = api.ok("GET", f"/jobs/{job_id}/logs")["lines"]
        if proc.returncode != 0 or job["status"] != "succeeded":
            raise SmokeFailure(f"R: ftc-ctl exited {proc.returncode}, job {job['status']} "
                               f"(statuses {statuses}); ctl stderr {err[-2000:]}; log tail:\n"
                               + "\n".join(logs[-30:]))
        want = ["running", "retrying", "running", "succeeded"]
        it = iter(statuses)
        if not all(st in it for st in want):
            raise SmokeFailure(f"R: statuses {statuses}, want the order {want}")
        history = job["metadata"].get("attempt_history") or []
        if len(history) != 1 or history[0].get("failure_class") != "infra" \
                or history[0].get("exit_code") not in (-9, 137):
            raise SmokeFailure(f"R: attempt_history {history}")
        records = _job_rows(api, job_id, RESILIENCE_ARGS["total_steps"], "R")
        sandbox = settings.state_path / "sandboxes" / job_id
        with open(sandbox / "artifacts" / "metrics.csv") as f:
            csv_steps = [int(float(r["step"])) for r in csv.DictReader(f)]
        if csv_steps != list(range(1, RESILIENCE_ARGS["total_steps"] + 1)):
            raise SmokeFailure(f"R: metrics.csv steps {csv_steps}")
        ckpt_dir = sandbox / "artifacts" / "checkpoints"
        staging = [p.name for p in ckpt_dir.iterdir() if ".tmp" in p.name]
        committed = CheckpointManager(ckpt_dir, sweep=False).steps()
        if staging or committed != [2, 4, 6]:
            raise SmokeFailure(f"R: checkpoints {sorted(p.name for p in ckpt_dir.iterdir())}")
        # the artifact sync ships committed steps only, never a save's staging
        stored = sorted(p.name for p in
                        (rt.store.path_for(job["artifacts_uri"]) / "checkpoints").iterdir())
        if stored != [f"step_{s}" for s in committed]:
            raise SmokeFailure(f"R: the object store holds checkpoints {stored}")
        manifests = {}
        for step in committed:
            path = ckpt_dir / f"step_{step}"
            manifest = json.loads((path / MANIFEST_NAME).read_text())
            state = torch.load(path / "state.pt", map_location="cpu", weights_only=True)
            got = {k: v["shape"] for k, v in manifest["leaves"].items()}
            if manifest["step"] != step or got != {
                    k: v["shape"] for k, v in leaf_entries(state).items()}:
                raise SmokeFailure(f"R: step_{step}'s manifest does not match its state")
            manifests[step] = len(got)
            del state
        kill_ts = (sandbox / "fault_fired").stat().st_mtime
        resumed_from, outcome = resume_outcome(
            logs, (ckpt_dir / "step_2" / MANIFEST_NAME).stat().st_mtime, kill_ts)
        events = [json.loads(ln) for ln in
                  (sandbox / "artifacts" / "events.jsonl").read_text().splitlines()]
        launches = attempt_launches(events)
        if len(launches) != 2 or any(a.get(name, 0) <= 0 for a in launches
                                     for name in FLASH_KERNELS):
            raise SmokeFailure(f"R: flash launches by attempt {launches}: each attempt's "
                               f"steps must launch every flash kernel")
        # the host-side cost of each save (snapshot + handoff when async,
        # snapshot + write when blocking), from the trainer's checkpoint
        # spans; the phase_checkpoint_ms column carries it in the next row
        spans = [json.loads(ln) for ln in
                 (sandbox / "artifacts" / "trace" / "trainer.jsonl").read_text().splitlines()]
        checkpoint_ms = {sp["attributes"]["step"]: {
            "ms": (sp["end_ns"] - sp["start_ns"]) / 1e6,
            "snapshot_ms": sp["attributes"].get("snapshot_ms"),
            "blocking": sp["attributes"].get("blocking"), "attempt": sp["attributes"].get("attempt")}
            for sp in spans if sp["name"] == "checkpoint"}
    losses = [r["loss"] for r in records]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, control["losses"])]
    if len(gaps) != len(losses) or max(gaps) > RESILIENCE_LOSS_REL_TOL:
        raise SmokeFailure(f"R: losses {losses} vs C's {control['losses']} "
                           f"(largest rel gap {max(gaps):.3g}, tolerance "
                           f"{RESILIENCE_LOSS_REL_TOL})")
    commits = {}
    for ln in logs:
        m = re.search(r"checkpoint step_(\d+) committed in ([0-9.]+) s \((\d+) bytes\)", ln)
        if m:
            commits.setdefault(int(m.group(1)), []).append(float(m.group(2)))
    written = DISK.written() - disk0
    cost = save_cost(records, checkpoint_ms, resumed_from)
    record = {
        "job_id": job_id, "statuses": statuses, "attempt_history": history,
        "resumed_from": resumed_from, "kill_outcome": outcome,
        "flash_launches_by_attempt": launches,
        "flash_launches": {name: sum(a[name] for a in launches) for name in FLASH_KERNELS},
        "losses": losses, "loss_rel_gap_max": max(gaps), "loss_rel_gaps": gaps,
        "submit_to_first_row_s": records[0]["timestamp"] - t_submit,
        "kill_to_resumed_first_row_s": records[RESILIENCE_KILL_AT - 1]["timestamp"] - kill_ts,
        "checkpoint_ms": checkpoint_ms, "commit_s_by_step": commits, "save_cost": cost,
        "ms_per_step": [RESILIENCE_TOKENS / r["tokens_per_sec"] * 1e3 for r in records],
        "phase_ms": {col: [r.get(f"phase_{col}_ms") for r in records]
                     for col in ("input", "compute", "sync", "checkpoint")},
        "manifest_leaves": manifests, "bytes_written": written,
        "ctl_stderr_lines": len(err.splitlines()),
    }
    log(f"R: {CONTROL_MODEL} through ftc-ctl, SIGKILL after step {RESILIENCE_KILL_AT}: "
        f"{' -> '.join(statuses)}; attempt_history {history}; {outcome}, so the second "
        f"attempt resumed from step {resumed_from}; flash launches by attempt {launches}; "
        f"submit -> first row {record['submit_to_first_row_s']:.1f} s, kill -> resumed first "
        f"row {record['kill_to_resumed_first_row_s']:.1f} s; steps "
        f"{[round(x) for x in record['ms_per_step']]} ms, compute "
        f"{[round(x or 0) for x in record['phase_ms']['compute']]} ms; checkpoint spans "
        f"{ {k: (round(v['ms'], 1), round(v['snapshot_ms'] or 0, 1), v['blocking']) for k, v in checkpoint_ms.items()} } "
        f"(step: (ms, snapshot ms, blocking)); writer commit s {commits}; async save cost "
        f"{cost}; losses equal C's within rel {max(gaps):.3g} (tolerance "
        f"{RESILIENCE_LOSS_REL_TOL}); manifests {manifests} leaves, no staging in the "
        f"sandbox or the store; "
        f"{written / 1e9:.2f} GB written")
    if written > RESILIENCE_DISK_BYTES:
        raise SmokeFailure(f"R: {written / 2**30:.2f} GiB written (budget "
                           f"{RESILIENCE_DISK_BYTES / 2**30:.0f} GiB)")
    record["snapshot"] = snapshot_check(work, seed)
    record["phase_s"] = time.perf_counter() - t_phase
    return record


def snapshot_check(work, seed: int) -> dict:
    """R2: the asynchronous save's snapshot on the card.  A 2-layer,
    full-width ``llama3-8b`` LoRA trainer (bf16 base, rank 16, 2 x 2048
    random tokens a step, no prefetch) fits 5 steps with a checkpoint every
    2: the saves of steps 2 and 4 are asynchronous and overlap the next
    step, step 5's blocks.  The live trainable tensors after step 4 (copied
    in ``on_metrics``, before the save) must equal the step-4 checkpoint
    read back, bit for bit."""
    import torch
    from finetune_controller_tpu_torch.models.llama import PRESETS
    from finetune_controller_tpu_torch.models.lora import LoRAConfig
    from finetune_controller_tpu_torch.train.checkpoint import CheckpointManager
    from finetune_controller_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = PRESETS["llama3-8b"].replace(n_layers=2, lora=LoRAConfig(rank=16, alpha=32.0))
    trainer = Trainer(cfg, TrainConfig(frozen_dtype="bfloat16", batch_size=2, seq_len=2048,
                                       total_steps=5, checkpoint_every=2, log_every=1,
                                       warmup_steps=1, prefetch=0, seed=seed,
                                       heartbeat_interval_s=0), device=DEVICE)
    rng = np.random.default_rng(seed + 11)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 2048)).astype(np.int32)}
               for _ in range(5)]
    live = {}

    def keep(step, _metrics):
        if step == 4:
            live.update({k: v.detach().to("cpu", copy=True) for k, v in trainer.trainable.items()})

    art = Path(work) / "snapshot_check"
    shutil.rmtree(art, ignore_errors=True)
    trainer.fit(batches, str(art), on_metrics=keep)
    saved = CheckpointManager(art / "checkpoints", sweep=False).restore(4)["trainable"]
    differ = [k for k in live if not torch.equal(saved[k], live[k])]
    events = [json.loads(ln) for ln in (art / "events.jsonl").read_text().splitlines()]
    commits = {e["attrs"].get("step"): bool(e["attrs"].get("blocking")) for e in events
               if e["event"] == "checkpoint-committed"}
    if commits != {2: False, 4: False, 5: True}:
        raise SmokeFailure(f"R2: checkpoint events (step: blocking) {commits}, want steps 2 "
                           f"and 4 asynchronous and step 5 blocking")
    if differ or len(live) != len(saved) or not live:
        raise SmokeFailure(f"R2: the step-4 checkpoint differs from the live tensors on "
                           f"{differ[:5]} ({len(live)} live, {len(saved)} saved)")
    del trainer
    torch.cuda.empty_cache()
    log(f"R2: the async step-4 save read back equals the live trainable tensors after step 4 "
        f"({len(live)} tensors, bit for bit); checkpoint events {commits}")
    cost = snapshot_cost(seed)
    log(f"R2: snapshot of C's adapter state ({cost['leaves']} f32 leaves, "
        f"{cost['bytes'] / 1e9:.3f} GB) to the host, three rounds: fresh pageable tensors "
        f"{[round(x, 1) for x in cost['ms']['pageable']]} ms, fresh pinned tensors "
        f"{[round(x, 1) for x in cost['ms']['pinned']]} ms, the same pinned buffers each "
        f"round (a training run's saves; the first round allocates them) "
        f"{[round(x, 1) for x in cost['ms']['reused']]} ms")
    return {"tensors": len(live), "commit_events": commits, "snapshot_cost": cost}


def snapshot_cost(seed: int) -> dict:
    """R2: what a checkpoint's snapshot costs at the size of C's adapter
    state (llama3-8b, 32 layers, LoRA rank 16 on the seven projections:
    448 f32 leaves and Adam's two moments of each), made on the card, in
    three ways: into fresh pageable tensors (``Trainer.state_dict``), into
    fresh pinned tensors (the second run gets the blocks the first freed
    to the caching host allocator), and into one set of pinned buffers
    reused by every run, as a training run's saves reuse theirs
    (``Trainer._checkpoint_state``).  Three rounds, alternating; each copy
    is checked bit for bit on its first leaf.  Nothing is written to the
    disk."""
    import torch
    from finetune_controller_tpu_torch.models.llama import PRESETS

    cfg, rank = PRESETS["llama3-8b"], CONTROL_ARGS["lora_rank"]
    q, kv = cfg.n_heads * (cfg.d_model // cfg.n_heads), cfg.n_kv_heads * (cfg.d_model // cfg.n_heads)
    projections = [(cfg.d_model, q), (cfg.d_model, kv), (cfg.d_model, kv), (q, cfg.d_model),
                   (cfg.d_model, cfg.d_ff), (cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)]
    shapes = [s for _ in range(cfg.n_layers) for i, o in projections for s in ((i, rank), (rank, o))]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    leaves = [torch.randn(s, generator=gen, device=DEVICE) for s in shapes for _ in range(3)]
    kept: list = []

    def pageable():
        return [v.to("cpu", copy=True) for v in leaves]

    def pinned(bufs=None):
        out = [(b if b is not None else torch.empty(v.shape, dtype=v.dtype, pin_memory=True))
               .copy_(v, non_blocking=True) for v, b in zip(leaves, bufs or [None] * len(leaves))]
        torch.cuda.synchronize()
        return out

    def reused():
        if not kept:
            kept.extend(torch.empty(v.shape, dtype=v.dtype, pin_memory=True) for v in leaves)
        return pinned(kept)

    first = leaves[0].cpu()
    ms = {"pageable": [], "pinned": [], "reused": []}
    for _ in range(3):
        for name, fn in (("pageable", pageable), ("pinned", pinned), ("reused", reused)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host = fn()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            if not torch.equal(host[0], first):
                raise SmokeFailure(f"R2: the {name} snapshot differs from the card's tensor")
            del host
    nbytes = sum(v.numel() * v.element_size() for v in leaves)
    del leaves, kept
    torch.cuda.empty_cache()
    return {"leaves": len(shapes) * 3, "bytes": nbytes, "ms": ms}


#: T5: the reference's remat policies, run once each at T3's shape
# ---------------------------------------------------------------------------
# W: worker-process serving and a warm trainer start
# ---------------------------------------------------------------------------

#: W1's control plane: C's settings with every replica a worker process
#: (two of them), a fast health loop and restart backoff
W_ENV = {**CONTROL_ENV, "FTC_SERVE_TRANSPORT": "process", "FTC_SERVE_REPLICAS": "2",
         "FTC_SERVE_WORKER_HEARTBEAT_S": "1", "FTC_SERVE_HEALTH_INTERVAL_S": "0.5",
         "FTC_RETRY_BASE_DELAY_S": "0.5", "FTC_RETRY_MAX_DELAY_S": "2"}
#: W1's tenant session: C's own adapter as tenant #1 and one more
W_TENANT_ENV = {**W_ENV, "FTC_SERVE_MAX_ADAPTERS": "2",
                "FTC_SERVE_ADAPTER_RANK": str(CONTROL_ARGS["lora_rank"])}
#: the decode step of worker r0 at which the tenant session SIGKILLs it
W_KILL_AT_STEP = 8
#: prompt lengths W1 sends beside C's four, in each session
W_PROMPTS = (64, 200, 333, 480)
W_TENANT_PROMPTS = (40, 150, 300, 450)
#: W2: C's job at full width and depth, 3 steps, one checkpoint at the end, no
#: profiler window, in a warm trainer process
W2_ARGS = {**{k: v for k, v in CONTROL_ARGS.items() if k != "profile_steps"},
           "total_steps": 3, "checkpoint_every": 3}
W2_ENV = {**CONTROL_ENV, "FTC_WARM_WORKERS": "1"}
#: what W may write (its ``DiskTally``)
W_DISK_BYTES = int(2.5 * 2**30)
#: flash launches per training step of C's shape (``C_LAYERS`` layers, 2
#: microbatches; ``mlp`` remat runs each layer's forward twice)
FLASH_PER_STEP = {"flash_forward": 4 * C_LAYERS, "flash_backward_dq": 2 * C_LAYERS,
                  "flash_backward_dkv": 2 * C_LAYERS}


def _free_cuda() -> None:
    gc.collect()
    if DEVICE == "cuda":
        import torch

        torch.cuda.empty_cache()


def card_used_mb() -> float:
    """The card's used memory (``nvidia-smi``, MB, every process on it)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) if out.returncode == 0 else float("nan")


def _workers(on_loop, fleet) -> dict:
    """Each live worker's probe (its stats carry the paged kernel's launches
    since warm-up and the process's peak card memory), spawn seconds (spec
    written -> socket bound, from its sandbox) and pid."""
    async def probe_all():
        return {rid: await r.batcher.health_probe() for rid, r in list(fleet.replicas.items())}

    out = {}
    for rid, probe in on_loop(probe_all(), 120).items():
        replica = fleet.replicas[rid].batcher
        box = Path(replica.sandbox)
        out[rid] = {
            "pid": replica.pid,
            "paged_launches": probe["stats"]["paged_launches"],
            "peak_gb": probe["stats"]["cuda_peak_bytes"] / 1e9,
            "spawn_s": ((box / "transport.json").stat().st_mtime
                        - (box / "worker_spec.json").stat().st_mtime),
            "requests_completed": probe["stats"]["requests_completed_total"],
        }
    return out


def _drain_all(on_loop, fleet, tag: str) -> dict:
    """Drain every worker through the fleet; each must exit 0."""
    procs = {rid: r.batcher._proc for rid, r in fleet.replicas.items()}
    for rid in list(procs):
        on_loop(fleet.drain_replica(rid, reason=f"{tag} drain"), 120)
    codes = {rid: proc.wait(timeout=30) for rid, proc in procs.items()}
    if any(code != 0 for code in codes.values()):
        raise SmokeFailure(f"{tag}: drained workers exited {codes}")
    return codes


def _post_all(api, job_id: str, bodies: list[dict]) -> tuple[list[dict], float]:
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(bodies)) as pool:
        answers = list(pool.map(
            lambda b: api.ok("POST", f"/jobs/{job_id}/generate", b), bodies))
    return answers, time.perf_counter() - t0


def _ttft_by_replica(on_loop, fleet, prompt, reps: int = 3) -> dict:
    """Median seconds of a 1-token request sent to each worker alone (the
    client's clock around the RPC)."""
    from finetune_controller_tpu_torch.serve.engine import GenRequest

    async def one(replica, i):
        t0 = time.perf_counter()
        await replica.batcher.submit(GenRequest(f"ttft-{replica.replica_id}-{i}", prompt, 1))
        return time.perf_counter() - t0

    out = {}
    for rid, replica in list(fleet.replicas.items()):
        times = sorted(on_loop(one(replica, i), 120) for i in range(reps))
        out[rid] = times[len(times) // 2]
    return out


def _per_replica_rates(answers, wall: float) -> dict:
    by = {}
    for a in answers:
        by[a["replica_id"]] = by.get(a["replica_id"], 0) + len(a["tokens"])
    return {rid: n / wall for rid, n in sorted(by.items())}


def _w1_merged(ctx, control: dict, seed: int) -> dict:
    """W1a: C's job merged in two worker processes: 8 requests (C's 4
    prompts among them) equal C's answers and an in-process engine over
    the same staged prefix."""
    from finetune_controller_tpu_torch.serve.engine import BatchEngine, GenRequest
    from finetune_controller_tpu_torch.serve.loader import load_serving_model

    api, scrape, rt, settings, on_loop, ctrl = ctx
    job_id = control["job_id"]
    t0 = time.time()
    meta = api.ok("POST", f"/admin/serve/{job_id}/load")["model"]
    load_s = time.time() - t0
    session = rt.serve.sessions[job_id]
    fleet = session.fleet
    stats = fleet.stats()
    pids = stats["worker_pids"]
    if stats["transport"] != "process" or len(set(pids)) != 2 or os.getpid() in pids:
        raise SmokeFailure(f"W1: transport {stats['transport']}, worker pids {pids}")
    used_mb = card_used_mb()
    rng = np.random.default_rng(seed + 11)
    prompts = list(control["prompts"]) + [
        rng.integers(0, meta["vocab_size"], n).tolist() for n in W_PROMPTS]
    bodies = [{"tokens": p, "max_new_tokens": CONTROL_NEW_TOKENS, "request_id": f"w{i}"}
              for i, p in enumerate(prompts)]
    answers, wall = _post_all(api, job_id, bodies)
    got = {a["request_id"]: a["tokens"] for a in answers}
    if len(got) != len(prompts) or any(len(t) != CONTROL_NEW_TOKENS for t in got.values()):
        raise SmokeFailure(f"W1: answers {[(k, len(v)) for k, v in got.items()]}")
    differ_c = [i for i in range(len(control["prompts"]))
                if got[f"w{i}"] != control["answers"][f"c{i}"]]
    ttft = _ttft_by_replica(on_loop, fleet, prompts[1])
    workers = _workers(on_loop, fleet)
    model, _ = load_serving_model(session.worker_stage_dir,
                                  merge_lora=settings.serve_merge_lora, device=DEVICE)
    ref = BatchEngine(model, rt.serve._engine_config()).run(
        [GenRequest(f"w{i}", p, CONTROL_NEW_TOKENS) for i, p in enumerate(prompts)])
    differ = [rid for rid, toks in got.items() if toks != ref[rid].generated]
    del model, ref
    _free_cuda()
    if differ_c or differ:
        raise SmokeFailure(f"W1: tokens differ from C's answers on {differ_c} and from the "
                           f"in-process engine on {differ}")
    if DEVICE == "cuda" and any(w["paged_launches"] <= 0 for w in workers.values()):
        raise SmokeFailure(f"W1: a worker did not launch the paged kernel: {workers}")
    codes = _drain_all(on_loop, fleet, "W1")
    api.ok("POST", f"/admin/serve/{job_id}/unload")
    generated = sum(len(t) for t in got.values())
    return {"load_s": load_s, "lora_merged": meta["lora_merged"], "workers": workers,
            "card_used_gb_both_up": used_mb / 1e3, "requests": len(prompts),
            "requests_equal_c": len(control["prompts"]), "generated_tokens": generated,
            "decode_tokens_per_s": generated / wall,
            "decode_tokens_per_s_by_replica": _per_replica_rates(answers, wall),
            "ttft_s_by_replica": ttft, "drain_exit_codes": codes}


def _w1_tenants(ctx, control: dict, dpo: dict, seed: int, once: Path) -> dict:
    """W1b: C's job multi-tenant in two worker processes, P1's adapter
    loaded through the admin route; worker r0 SIGKILLs itself at decode
    step ``W_KILL_AT_STEP``; every request is answered once with the
    tokens of an in-process tenant engine over the same staged prefix, and
    the respawned worker (synced by ``stack_sync``) answers the same."""
    from finetune_controller_tpu_torch.serve.adapters import AdapterRegistry
    from finetune_controller_tpu_torch.serve.engine import BatchEngine, GenRequest
    from finetune_controller_tpu_torch.serve.loader import (
        load_serving_model,
        strip_lora_for_multitenant,
    )

    api, scrape, rt, settings, on_loop, ctrl = ctx
    job_id, dpo_id = control["job_id"], dpo["job_id"]
    meta = api.ok("POST", f"/admin/serve/{job_id}/load")["model"]
    adapter = api.ok("POST", f"/admin/serve/{job_id}/adapters/{dpo_id}/load")["adapter"]
    session = rt.serve.sessions[job_id]
    fleet = session.fleet
    if not meta.get("self_adapter") or len(fleet.adapters) != 2:
        raise SmokeFailure(f"W1: tenant session meta {meta}, adapters {fleet.adapters.stats()}")
    first = dict(fleet.replicas)
    rng = np.random.default_rng(seed + 12)
    prompts = list(control["prompts"]) + [
        rng.integers(0, meta["vocab_size"], n).tolist() for n in W_TENANT_PROMPTS]
    bodies = [{"tokens": p, "max_new_tokens": CONTROL_NEW_TOKENS, "request_id": f"t{i}",
               **({"adapter": dpo_id} if i % 2 else {})} for i, p in enumerate(prompts)]
    answers, _ = _post_all(api, job_id, bodies)
    ids = [a["request_id"] for a in answers]
    if sorted(ids) != sorted(b["request_id"] for b in bodies) or not once.exists():
        raise SmokeFailure(f"W1: answered {ids}; the kill fired: {once.exists()}")
    t_kill = once.stat().st_mtime
    deadline = time.time() + 180
    while fleet.replica_restarts_total < 1 or len(fleet.healthy_replicas()) < 2:
        if time.time() > deadline:
            raise SmokeFailure(f"W1: no respawn: {fleet.stats()['replicas']}")
        time.sleep(0.2)
    respawn_s = time.time() - t_kill
    failovers = session.router.failovers_total
    fresh = [rid for rid in fleet.replicas if rid not in first]
    if failovers < 1 or len(fresh) != 1:
        raise SmokeFailure(f"W1: failovers {failovers}, new workers {fresh}")
    again = {}
    for i in range(1, len(prompts), 2):
        req = GenRequest(f"again{i}", prompts[i], CONTROL_NEW_TOKENS, adapter_id=dpo_id)
        again[f"t{i}"] = on_loop(fleet.replicas[fresh[0]].batcher.submit(req), 300).generated
    workers = _workers(on_loop, fleet)
    prom = scrape.ok("GET", "/metrics", raw=True)
    counters = {name: _prom_value(prom, f"ftc_serve_transport_{name}") for name in
                ("rpcs_total", "bytes_total", "worker_respawns_total")}
    # the oracle: the same staged prefix unmerged, both tenants in one engine
    model, _ = load_serving_model(session.worker_stage_dir, merge_lora=False, device=DEVICE)
    base, tree, alpha, rank = strip_lora_for_multitenant(model)
    del model
    registry = AdapterRegistry(settings.serve_max_adapters + 1, settings.serve_adapter_rank)
    registry.register(job_id, tree, alpha, rank)
    entry = fleet.adapters.get(dpo_id)
    registry.register(dpo_id, entry.tree, entry.alpha, entry.rank)
    engine = BatchEngine(base, rt.serve._engine_config(), adapters=registry)
    ref = engine.run([GenRequest(b["request_id"], b["tokens"], CONTROL_NEW_TOKENS,
                                 adapter_id=b.get("adapter") or job_id) for b in bodies])
    del engine, base
    _free_cuda()
    differ = [a["request_id"] for a in answers if a["tokens"] != ref[a["request_id"]].generated]
    differ += [f"respawned {rid}" for rid, toks in again.items() if toks != ref[rid].generated]
    if differ:
        raise SmokeFailure(f"W1: tenant tokens differ from the in-process tenant engine on "
                           f"{differ}")
    if min(counters.values()) <= 0:
        raise SmokeFailure(f"W1: /metrics transport counters {counters}")
    if DEVICE == "cuda" and any(w["paged_launches"] <= 0 for w in workers.values()):
        raise SmokeFailure(f"W1: a worker did not launch the paged kernel: {workers}")
    codes = _drain_all(on_loop, fleet, "W1")
    api.ok("POST", f"/admin/serve/{job_id}/unload")
    return {"adapter_slot": adapter["slot"], "killed": "r0", "kill_at_step": W_KILL_AT_STEP,
            "requests": len(bodies), "answered_once": len(set(ids)), "failovers": failovers,
            "respawns": fleet.replica_restarts_total, "kill_to_respawned_s": respawn_s,
            "respawned": fresh[0], "respawned_requests_equal": len(again),
            "workers": workers, "transport_counters": counters, "drain_exit_codes": codes}


def _w2_warm(ctx, work, control: dict) -> dict:
    """W2: C's job (3 steps) started in a warm trainer process."""
    api, scrape, rt, settings, on_loop, ctrl = ctx
    on_loop(rt.backend.prewarm(wait_s=240), 300)
    pool = [p for procs in rt.backend._warm.values() for p in procs if p.returncode is None]
    if len(pool) != 1 or not Path(pool[0].ftc_ready_path).exists():
        raise SmokeFailure(f"W2: warm pool {[(p.pid, p.returncode) for p in pool]} not ready")
    warm_pid = pool[0].pid
    docs = Path(work) / "train.jsonl"
    dataset = api.ok("POST", "/datasets", files={"file": ("train.jsonl", docs.read_bytes())},
                     want=(201,))
    t_submit = time.time()
    job_id = api.ok("POST", "/jobs", fields={
        "model_name": CONTROL_MODEL, "device": CONTROL_FLAVOR,
        "dataset_id": dataset["dataset_id"], "arguments": json.dumps(W2_ARGS)})["job_id"]
    job, seen, logs = _follow_job(api, job_id, t_submit, "W2")
    records = _job_rows(api, job_id, W2_ARGS["total_steps"], "W2")
    _, at = _timeline(api, job_id, ("submitted", "train-started", "succeeded"), "W2")
    # the card the backend grants the job (the first visible one)
    card = "" if rt.catalog.get(CONTROL_FLAVOR).runtime == "cpu" else (
        os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")[0] or "0")
    want = (f"warm worker pid={warm_pid}: CUDA_VISIBLE_DEVICES={card} applied with CUDA "
            f"initialised before the request: False")
    if not any(want in line for line in logs):
        raise SmokeFailure(f"W2: the job's log lacks {want!r}; head:\n" + "\n".join(logs[:10]))
    sandbox = settings.state_path / "sandboxes" / job_id
    events = [json.loads(ln) for ln in
              (sandbox / "artifacts" / "events.jsonl").read_text().splitlines()]
    launches = attempt_launches(events)
    steps = W2_ARGS["total_steps"]
    per_step = {name: launches[0].get(name, 0) / steps for name in FLASH_KERNELS} \
        if len(launches) == 1 else None
    if per_step != {name: float(FLASH_PER_STEP[name]) for name in FLASH_KERNELS}:
        raise SmokeFailure(f"W2: flash launches {launches} over {steps} steps, want "
                           f"{FLASH_PER_STEP} a step")
    replenished = [p.pid for procs in rt.backend._warm.values() for p in procs
                   if p.returncode is None]
    return {"job_id": job_id, "warm_pid": warm_pid,
            "submit_to_first_step_s": records[0]["timestamp"] - at["submitted"],
            "submit_to_train_started_s": at["train-started"] - at["submitted"],
            "cold_submit_to_first_step_s": control["submit_to_first_step_s"],
            "cold_submit_to_train_started_s": control["submit_to_train_started_s"],
            "losses": [r["loss"] for r in records], "flash_launches": launches[0],
            "flash_launches_per_step": per_step, "pool_after_job": replenished}


def worker_phase(work, seed: int, control: dict, dpo: dict) -> dict:
    """W (after C and P1, on C's state and object store under
    ``build/chip_smoke_ctrl``): W1 serves C's promoted job from worker
    processes (:func:`_w1_merged`, then :func:`_w1_tenants` with a
    SIGKILL), W2 starts C's job in a warm trainer process
    (:func:`_w2_warm`); the phase's writes stay within ``W_DISK_BYTES``."""
    from finetune_controller_tpu_torch.resilience.faults import ServeFault

    t_phase = time.perf_counter()
    disk0 = DISK.written()
    ctrl = Path(__file__).resolve().parent / "build" / "chip_smoke_ctrl"
    plugins = ctrl / "plugins"  # C's: W2 runs C's job at C's depth
    with control_plane(ctrl, W_ENV, plugin_dir=plugins) as ctx:
        merged = _w1_merged(ctx, control, seed)
    once = ctrl / "w1_fault_fired"
    once.unlink(missing_ok=True)
    fault = ServeFault(replica_id="r0", at_step=W_KILL_AT_STEP, mode="kill",
                       once_file=str(once)).to_env()
    with control_plane(ctrl, {**W_TENANT_ENV, **fault}, plugin_dir=plugins) as ctx:
        tenants = _w1_tenants(ctx, control, dpo, seed, once)
    DISK.mark("W1")
    with control_plane(ctrl, W2_ENV, plugin_dir=plugins) as ctx:
        warm = _w2_warm(ctx, work, control)
    written = DISK.written() - disk0
    record = {"w1": merged, "w1_tenants": tenants, "w2": warm, "bytes_written": written,
              "phase_s": time.perf_counter() - t_phase}
    launches = {f"{tag}_{rid}": w["paged_launches"]
                for tag, part in (("merged", merged), ("tenants", tenants))
                for rid, w in part["workers"].items()}
    record["paged_launches"] = launches
    log(f"W1: {CONTROL_MODEL} (C's promoted job) from 2 worker processes on the card: load "
        f"{merged['load_s']:.1f} s (one staging, workers spawned together), spawn s by worker "
        f"{ {k: round(w['spawn_s'], 1) for k, w in merged['workers'].items()} }, peak GB by "
        f"worker { {k: round(w['peak_gb'], 2) for k, w in merged['workers'].items()} }, card "
        f"used with both up {merged['card_used_gb_both_up']:.1f} GB; {merged['requests']} "
        f"requests, tokens equal C's answers (4) and an in-process engine over the staged "
        f"prefix (8); decode {merged['decode_tokens_per_s']:.1f} tokens/s in all, by replica "
        f"{ {k: round(v, 1) for k, v in merged['decode_tokens_per_s_by_replica'].items()} } "
        f"(C in process: {control['decode_tokens_per_s']:.1f} over 4 requests); TTFT of a "
        f"1-token request by replica "
        f"{ {k: round(v * 1e3, 1) for k, v in merged['ttft_s_by_replica'].items()} } ms "
        f"(C in process: {control['ttft_s'] * 1e3:.1f} ms, server histogram); drains exit "
        f"{merged['drain_exit_codes']}")
    log(f"W1 tenants: C's adapter and P1's (slot {tenants['adapter_slot']}) on both workers; "
        f"r0 SIGKILLed at decode step {W_KILL_AT_STEP}: {tenants['answered_once']}/"
        f"{tenants['requests']} answered once, {tenants['failovers']} failover(s), "
        f"{tenants['respawns']} respawn(s) ({tenants['respawned']}, "
        f"{tenants['kill_to_respawned_s']:.1f} s after the kill, its adapters by stack_sync, "
        f"{tenants['respawned_requests_equal']} requests equal), tokens equal an in-process "
        f"tenant engine; paged launches by worker {launches}; /metrics "
        f"{tenants['transport_counters']}; drains exit {tenants['drain_exit_codes']}")
    log(f"W2: {CONTROL_MODEL} ({W2_ARGS['total_steps']} steps) in warm trainer pid "
        f"{warm['warm_pid']}: submit -> train-started {warm['submit_to_train_started_s']:.1f} "
        f"s, -> first row {warm['submit_to_first_step_s']:.1f} s (C cold: "
        f"{warm['cold_submit_to_train_started_s']:.1f} s, "
        f"{warm['cold_submit_to_first_step_s']:.1f} s); flash launches a step "
        f"{warm['flash_launches_per_step']}; pool after the job {warm['pool_after_job']}; W "
        f"wrote {written / 1e9:.2f} GB in {record['phase_s']:.1f} s")
    if written > W_DISK_BYTES:
        raise SmokeFailure(f"W: {written / 2**30:.2f} GiB written (budget "
                           f"{W_DISK_BYTES / 2**30:.1f} GiB)")
    return record


#: phase D: C's job with its state in the shared state service
#: (``statestore_main``), its objects on S3 (an endpoint in this script) and
#: its log followed over a WebSocket; the trainer's first step line opens
#: the stream's gate
D_SEARCH = "step 1 loss"
D_REGION = "us-chip-1"
D_CREDENTIALS = {"AWS_ACCESS_KEY_ID": "AKIDCHIPSMOKE", "AWS_SECRET_ACCESS_KEY": "chip-smoke-secret"}
D_STATE_TOKEN = "chip-smoke-state-token"
#: the most D may write: the job's sandbox, the artifact sync's and the
#: sidecar's copies on S3, two stagings of the promoted checkpoint
D_DISK_BYTES = 3 * 2**30
#: seconds the monitor daemon and the state service get to exit on SIGTERM
D_STOP_S = 10
#: D's depth (``LLAMA_CUT_PLUGIN``): K runs after D in a run that must end
#: inside 1200 s (16 until the run's cuts for the slower card machines)
D_LAYERS = 8


class S3Endpoint:
    """An S3-compatible endpoint on the port's ``controller/web.py``, on
    ``127.0.0.1`` and its own event-loop thread, its objects files under
    ``root/<bucket>/<key>``.  Every request's SigV4 signature is derived
    again with the known secret (``controller/s3.py``'s signer) and a
    mismatch is a 403, as is a body whose SHA-256 is not the signed one.
    Served: PUT (single, and the parts of a multipart upload), GET
    (streamed), HEAD, DELETE, ListObjectsV2 with continuation tokens,
    DeleteObjects, the multipart create/complete/abort, and server-side
    copy (``x-amz-copy-source``) as a hard link, since an object is never
    written in place.  A multipart upload's parts are appended to the
    object's staging file in order, so completing it is a rename.  Each
    request's body bytes and seconds (head parsed to last byte) are kept,
    by method."""

    def __init__(self, root: Path):
        import threading

        from finetune_controller_tpu_torch.controller import web

        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.transfers: list[tuple[str, int, float]] = []
        self.refused: list[str] = []
        self.verified = 0
        #: upload id -> [the object's staging file, parts appended]
        self._uploads: dict[str, list] = {}
        app = web.Application(client_max_size=1 << 30)
        app.router.add_route("GET", "/{bucket}", self._handle)
        for method in ("GET", "PUT", "POST", "HEAD", "DELETE"):
            app.router.add_route(method, "/{bucket}/{key:.*}", self._handle)
        app.router.add_route("POST", "/{bucket}", self._handle)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, name="s3-endpoint",
                                       daemon=True)
        self.thread.start()
        self.runner = web.AppRunner(app)
        self._call(self.runner.setup())
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        self._call(site.start())
        self.endpoint = f"http://127.0.0.1:{site.port}"

    def _call(self, coro, timeout=60):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self) -> None:
        self._call(self.runner.cleanup())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()

    def path(self, bucket: str, key: str) -> Path:
        p = (self.root / bucket / key).resolve()
        if not p.is_relative_to(self.root.resolve()):
            raise ValueError(f"bad key {bucket}/{key}")
        return p

    def objects(self, bucket: str, prefix: str) -> dict[str, Path]:
        base = self.root / bucket
        found = {p.relative_to(base).as_posix(): p for p in base.rglob("*")
                 if p.is_file() and not p.name.endswith(".part-tmp")} if base.is_dir() else {}
        return {k: p for k, p in sorted(found.items()) if k.startswith(prefix)}

    def rate_gb_s(self, method: str) -> tuple[float | None, int]:
        rows = [(n, s) for m, n, s in self.transfers if m == method and n]
        total, secs = sum(n for n, _ in rows), sum(s for _, s in rows)
        return (total / secs / 1e9 if secs else None), total

    def _verify(self, request) -> str | None:
        from finetune_controller_tpu_torch.controller.s3 import sigv4_headers

        auth = request.headers.get("Authorization", "")
        if not auth.startswith("AWS4-HMAC-SHA256 "):
            return "missing sigv4 authorization"
        fields = dict(part.strip().split("=", 1)
                      for part in auth[len("AWS4-HMAC-SHA256 "):].split(","))
        signed = fields["SignedHeaders"].split(";")
        expect = sigv4_headers(
            request.method, request.headers["Host"], request.path,
            sorted(request.query.items()),
            payload_hash=request.headers.get("x-amz-content-sha256", ""),
            access_key=D_CREDENTIALS["AWS_ACCESS_KEY_ID"],
            secret_key=D_CREDENTIALS["AWS_SECRET_ACCESS_KEY"], region=D_REGION,
            amz_date=request.headers["x-amz-date"],
            extra_headers={k: request.headers[k] for k in signed
                           if k not in ("host", "x-amz-date", "x-amz-content-sha256")})
        if expect["authorization"] != auth:
            return "signature mismatch"
        return None

    async def _handle(self, request):
        import hashlib
        import urllib.parse
        import xml.etree.ElementTree as ET

        from finetune_controller_tpu_torch.controller import web

        t0 = time.perf_counter()
        err = self._verify(request)
        if err:
            self.refused.append(f"{request.method} {request.path}: {err}")
            return web.Response(status=403, text=err)
        self.verified += 1
        bucket = request.match_info["bucket"]
        key = request.match_info.get("key", "")
        q = request.query
        body, digest = b"", ""
        if request.method in ("PUT", "POST"):
            body = await request.read()
            digest = await asyncio.to_thread(lambda: hashlib.sha256(body).hexdigest())
            if digest != request.headers.get("x-amz-content-sha256"):
                self.refused.append(f"{request.method} {request.path}: payload hash")
                return web.Response(status=403, text="payload hash mismatch")

        def done(resp, n: int = 0):
            self.transfers.append((request.method, n, time.perf_counter() - t0))
            return resp

        if request.method == "POST" and "uploads" in q:
            upload_id = os.urandom(8).hex()
            self._uploads[upload_id] = [self.path(bucket, key).with_name(
                f"{Path(key).name}.{upload_id}.part-tmp"), 0]
            return done(web.Response(text=f"<InitiateMultipartUploadResult><UploadId>"
                                          f"{upload_id}</UploadId>"
                                          "</InitiateMultipartUploadResult>"))
        if request.method == "PUT" and "partNumber" in q:
            # parts are appended to the object's staging file as they come,
            # so they must come in order (the port's store sends them so)
            upload = self._uploads.get(q["uploadId"])
            n = int(q["partNumber"])
            if upload is None or n != upload[1] + 1:
                return done(web.Response(status=400, text=f"part {n} out of order"))
            await asyncio.to_thread(_append_file, upload[0], body)
            upload[1] = n
            return done(web.Response(headers={"ETag": f'"{digest[:32]}"'}), len(body))
        if request.method == "POST" and "uploadId" in q:
            upload = self._uploads.pop(q["uploadId"], None)
            if upload is None or not upload[0].exists():
                return done(web.Response(status=404, text="no such upload"))
            os.replace(upload[0], self.path(bucket, key))
            return done(web.Response(text="<CompleteMultipartUploadResult/>"))
        if request.method == "DELETE" and "uploadId" in q:
            upload = self._uploads.pop(q["uploadId"], None)
            if upload is not None:
                upload[0].unlink(missing_ok=True)
            return done(web.Response(status=204))
        if request.method == "POST" and "delete" in q:
            keys = [el.text or "" for el in ET.fromstring(body).iter()
                    if el.tag.split("}")[-1] == "Key"]
            for k in keys:
                self.path(bucket, k).unlink(missing_ok=True)
            return done(web.Response(text="<DeleteResult>" + "".join(
                f"<Deleted><Key>{k}</Key></Deleted>" for k in keys) + "</DeleteResult>"))
        if request.method == "PUT" and "x-amz-copy-source" in request.headers:
            src_bucket, _, src_key = urllib.parse.unquote(
                request.headers["x-amz-copy-source"]).lstrip("/").partition("/")
            src, dst = self.path(src_bucket, src_key), self.path(bucket, key)
            if not src.is_file():
                return done(web.Response(status=404))
            await asyncio.to_thread(_link_object, src, dst)
            return done(web.Response(text="<CopyObjectResult/>"))
        if request.method == "PUT":
            await asyncio.to_thread(_write_file, self.path(bucket, key), body)
            return done(web.Response(), len(body))
        if request.method == "GET" and not key:
            prefix = q.get("prefix", "")
            keys = list(self.objects(bucket, prefix).items())
            start = int(q.get("continuation-token") or 0)
            page = keys[start:start + 1000]
            more = start + 1000 < len(keys)
            contents = "".join(
                f"<Contents><Key>{k}</Key><Size>{p.stat().st_size}</Size><LastModified>"
                f"{time.strftime('%Y-%m-%dT%H:%M:%SZ', time.gmtime(p.stat().st_mtime))}"
                "</LastModified></Contents>" for k, p in page)
            tail = (f"<IsTruncated>true</IsTruncated><NextContinuationToken>{start + 1000}"
                    "</NextContinuationToken>" if more else "<IsTruncated>false</IsTruncated>")
            return done(web.Response(text=f"<ListBucketResult>{contents}{tail}</ListBucketResult>"))
        path = self.path(bucket, key) if key else None
        if path is None or not path.is_file():
            return done(web.Response(status=404))
        size = path.stat().st_size
        if request.method == "HEAD":
            return done(web.Response(headers={"Content-Length": str(size)}))
        if request.method == "DELETE":
            path.unlink()
            return done(web.Response(status=204))
        resp = web.StreamResponse(headers={"Content-Length": str(size),
                                           "Content-Type": "application/octet-stream"})
        await resp.prepare(request)
        with path.open("rb") as f:
            while chunk := await asyncio.to_thread(f.read, 1 << 22):
                await resp.write(chunk)
        await resp.write_eof()
        return done(resp, size)


def _write_file(path: Path, data: bytes) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".{os.getpid()}.part-tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def _append_file(path: Path, data: bytes) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("ab") as f:
        f.write(data)


def _link_object(src: Path, dst: Path) -> None:
    dst.parent.mkdir(parents=True, exist_ok=True)
    tmp = dst.with_name(dst.name + ".part-tmp")
    tmp.unlink(missing_ok=True)
    os.link(src, tmp)
    os.replace(tmp, dst)


def _sha_tree(root: Path) -> dict[str, str]:
    import hashlib

    out = {}
    for p in sorted(Path(root).rglob("*")):
        if p.is_file():
            h = hashlib.sha256()
            with p.open("rb") as f:
                while chunk := f.read(1 << 22):
                    h.update(chunk)
            out[p.relative_to(root).as_posix()] = h.hexdigest()
    return out


def _http_ok(url: str, token: str = "", timeout: float = 5) -> tuple[int, str]:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, headers={"Authorization": f"Bearer {token}"} if token
                                 else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _start_state_service(state_dir: Path, port: int, log_path: Path) -> tuple:
    """``statestore_main`` on ``state_dir`` as a subprocess; returns (the
    process, seconds until ``/healthz`` answered)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "finetune_controller_tpu_torch.controller.statestore_main",
         "--state-dir", str(state_dir), "--host", "127.0.0.1", "--port", str(port)],
        env={**os.environ, "FTC_STATE_TOKEN": D_STATE_TOKEN,
             "PYTHONPATH": str(Path(__file__).resolve().parent)},
        stdout=log_path.open("ab"), stderr=subprocess.STDOUT)
    while True:
        try:
            if _http_ok(f"http://127.0.0.1:{port}/healthz")[0] == 200:
                return proc, time.perf_counter() - t0
        except OSError:
            pass
        if proc.poll() is not None or time.perf_counter() - t0 > 120:
            proc.kill()
            raise SmokeFailure(f"D: the state service did not come up "
                               f"(exit {proc.poll()}); see {log_path}")
        time.sleep(0.05)


def _stop(proc, tag: str) -> int:
    proc.terminate()
    try:
        rc = proc.wait(timeout=D_STOP_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise SmokeFailure(f"{tag} did not exit within {D_STOP_S} s of SIGTERM")
    if rc != 0:
        raise SmokeFailure(f"{tag} exited {rc} on SIGTERM")
    return rc


class _WsFollow:
    """A WebSocket log follow on the port's client, on a thread: each
    message with its arrival time, until the server closes."""

    def __init__(self, url: str, token: str, tag: str = "D"):
        import threading

        self.url, self.token, self.tag = url, token, tag
        self.messages: list[tuple[float, str]] = []
        self.close: tuple | None = None
        self.error: BaseException | None = None
        self.thread = threading.Thread(target=self._run, name="ws-follow", daemon=True)
        self.thread.start()

    def _run(self) -> None:
        from finetune_controller_tpu_torch.controller import httpclient

        async def follow():
            session = httpclient.ClientSession()
            try:
                ws = await session.ws_connect(
                    self.url, headers={"Authorization": f"Bearer {self.token}"})
                while True:
                    msg = await ws.receive(timeout=CONTROL_JOB_TIMEOUT_S)
                    if msg.type.name in ("CLOSE", "CLOSED", "ERROR"):
                        self.close = (msg.type.name, msg.data, time.time())
                        break
                    self.messages.append((time.time(), msg.data))
                await ws.close()
            finally:
                await session.close()

        try:
            asyncio.run(follow())
        except BaseException as e:  # read by the phase, which fails on it
            self.error = e

    def join(self, timeout: float) -> None:
        self.thread.join(timeout)
        if self.thread.is_alive():
            raise SmokeFailure(f"{self.tag}: the WebSocket to {self.url} did not close")
        if self.error is not None:
            raise SmokeFailure(f"{self.tag}: the WebSocket follow failed: {self.error!r}")


def _percentile(values: list[float], q: float) -> float:
    s = sorted(values)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def storage_phase(work, seed: int, card: str = "not read") -> tuple[dict, dict]:
    """D, then K on D's S3 endpoint and state service (:func:`k8s_phase`);
    returns D's and K's records.

    D: the control plane's storage and streaming on the card.  The port's
    ``statestore_main`` runs as a subprocess on its own sqlite file, an S3
    endpoint (:class:`S3Endpoint`) runs in this process, and the port's
    server (in this process, as in C) keeps its state in the first
    (``state_backend=remote``) and its objects on the second
    (``object_store_backend=s3``), auth on.  T2's documents are uploaded;
    C's job (``CONTROL_MODEL``, ``CONTROL_ARGS``: full width, ``D_LAYERS``
    of its 32 layers by ``LLAMA_CUT_PLUGIN``) is
    submitted, and its log followed over ``GET {prefix}/logs/{id}`` with the
    gate ``D_SEARCH`` opened right after the submit; ``storage_cli sync``
    runs beside it as the pod's sidecar would.  Checked: SUCCEEDED; the
    stream's ``waiting:`` lines, then gated lines equal to the REST log from
    the gate on, a line for each step, closed after the job ended; a
    ``last_lines=20`` stream; the sidecar's exit 0; both S3 prefixes equal
    to the sandbox's files; ``storage_cli get`` of the dataset; the three
    flash kernels in the job's profile.  Then promotion from S3 and 4
    ``/generate`` requests against an in-process engine (the paged count
    must rise), a restart of the state service on its file with the job's
    record and rows unchanged, and the monitor daemon (``monitor_main``)
    against the same service and S3: ``/metrics`` labelled
    ``process="monitor"``, two ticks, the record unchanged, exit 0 on
    SIGTERM.  The local backend keeps its job handles in the API process,
    so the daemon cannot reconcile this job (K's, on the k8s backend, it
    does): it starts once the job ended (its process start overlapping the
    promotion and ``/generate``)."""
    t_phase = time.perf_counter()
    disk0 = DISK.written()
    d = Path(__file__).resolve().parent / "build" / "chip_smoke_d"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    docs = Path(work) / "train.jsonl"
    if not docs.exists():
        write_documents(docs, seed)
    (d / "plugins").mkdir()
    (d / "plugins" / "llama_depth.py").write_text(LLAMA_CUT_PLUGIN.format(layers=D_LAYERS))
    state_port = _free_port()
    service, service_up_s = _start_state_service(d / "statestore", state_port,
                                                 d / "statestore.log")
    s3 = S3Endpoint(d / "s3")
    procs: list = [service]
    try:
        store_env = {"FTC_OBJECT_STORE_BACKEND": "s3", "FTC_S3_ENDPOINT": s3.endpoint,
                     "FTC_S3_REGION": D_REGION, **D_CREDENTIALS}
        state_env = {"FTC_STATE_BACKEND": "remote",
                     "FTC_STATE_SERVICE_URL": f"http://127.0.0.1:{state_port}",
                     "FTC_STATE_SERVICE_TOKEN": D_STATE_TOKEN}
        with control_plane(d / "api", {**CONTROL_ENV, **state_env, **store_env},
                           plugin_dir=d / "plugins") as ctx:
            api, scrape, rt, settings, on_loop, ctrl = ctx
            rpc_ms: list[float] = []
            call = rt.state._call

            async def timed(method, retry_reads=False, **payload):
                t0 = time.perf_counter()
                try:
                    return await call(method, retry_reads, **payload)
                finally:
                    rpc_ms.append((time.perf_counter() - t0) * 1e3)

            rt.state._call = timed
            record = _storage_job(ctx, d, s3, docs, seed, procs, store_env, state_env)
            daemon = record.pop("daemon")
            # the state service restarts on its file; the job's record and
            # rows read the same through the server's client afterwards
            before = (api.ok("GET", f"/jobs/{record['job_id']}"),
                      api.ok("GET", f"/jobs/{record['job_id']}/metrics")["records"])
            t0 = time.perf_counter()
            _stop(service, "D: the state service")
            service, up_s = _start_state_service(d / "statestore", state_port,
                                                 d / "statestore.log")
            procs[0] = service
            record["state_restart_s"] = time.perf_counter() - t0
            after = (api.ok("GET", f"/jobs/{record['job_id']}"),
                     api.ok("GET", f"/jobs/{record['job_id']}/metrics")["records"])
            if after != before:
                raise SmokeFailure("D: the job's record or rows changed across the state "
                                   "service's restart")
            record["monitor"] = _check_monitor_daemon(daemon, d, api, record["job_id"], after[0])
            record["rpc_ms_p50"] = _percentile(rpc_ms, 0.5)
            record["rpc_ms_p99"] = _percentile(rpc_ms, 0.99)
            record["rpcs"] = len(rpc_ms)
        record["s3_put_gb_s"], record["s3_put_bytes"] = s3.rate_gb_s("PUT")
        record["s3_get_gb_s"], record["s3_get_bytes"] = s3.rate_gb_s("GET")
        record["s3_requests_verified"] = s3.verified
        if s3.refused:
            raise SmokeFailure(f"D: the S3 endpoint refused {s3.refused[:5]}")
        written = DISK.written() - disk0
        record.update(bytes_written=written, phase_s=time.perf_counter() - t_phase,
                      state_service_up_s=service_up_s)
        _report_storage(record)
        DISK.mark("D")
        k8s = k8s_phase(work, seed, d, s3, state_env, store_env, card)
        if s3.refused:
            raise SmokeFailure(f"K: the S3 endpoint refused {s3.refused[:5]}")
        _stop(service, "D: the state service")
    finally:
        s3.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return record, k8s


def _report_storage(record: dict) -> None:
    """D's line; fails past ``D_DISK_BYTES``."""
    written = record["bytes_written"]
    log(f"D: {CONTROL_MODEL} ({D_LAYERS} of 32 layers) on {CONTROL_FLAVOR} with its state "
        f"in statestore_main "
        f"(remote) and its objects on S3 (SigV4 verified on all {record['s3_requests_verified']} "
        f"requests): {' -> '.join(record['statuses'])}; submit -> RUNNING "
        f"{record['submit_to_running_s']:.1f} s, -> first WebSocket payload line "
        f"{record['submit_to_first_ws_line_s']:.1f} s; {record['waiting_lines']} waiting: "
        f"lines, then {record['ws_payload_lines']} gated lines equal to the REST log from "
        f"the gate on, steps {record['ws_steps']}, closed {record['ws_close_after_end_s']:.2f} "
        f"s after the job ended; a last_lines=20 stream opened while it ran gave the log's "
        f"last {record['tail_lines']} lines (of {record['tail_lines_before']} then); "
        f"{record['ms_per_step_median']:.0f} ms/step median of steps "
        f"{record['median_over_steps']}; S3 PUT {record['s3_put_gb_s']:.3f} GB/s over "
        f"{record['s3_put_bytes'] / 1e9:.2f} GB, GET {record['s3_get_gb_s']:.3f} GB/s over "
        f"{record['s3_get_bytes'] / 1e9:.2f} GB (the endpoint's request times); sidecar "
        f"exit 0, its final sync {record['sidecar_final_sync_s']:.2f} s after done.txt "
        f"({record['sidecar_s']:.1f} s in all); S3 prefixes equal the sandbox "
        f"({record['sandbox_files']} files); storage_cli get byte-equal; promote "
        f"{record['promote_s']:.2f} s, load {record['model_load_s']:.1f} s; {record['requests']}"
        f"/{record['requests']} /generate equal to the in-process engine, paged launches "
        f"{record['paged_launches']}; flash launches in the profile "
        f"{record['flash_launches_in_profile']}; state RPCs p50 {record['rpc_ms_p50']:.2f} ms, "
        f"p99 {record['rpc_ms_p99']:.2f} ms over {record['rpcs']}; state service restart "
        f"{record['state_restart_s']:.2f} s, record and rows unchanged; monitor daemon "
        f"{record['monitor']['ticks']:.0f} ticks, exit 0 "
        f"{record['monitor']['stop_s']:.2f} s after SIGTERM; D wrote {written / 1e9:.2f} GB "
        f"in {record['phase_s']:.1f} s")
    if written > D_DISK_BYTES:
        raise SmokeFailure(f"D: {written / 2**30:.2f} GiB written (budget "
                           f"{D_DISK_BYTES / 2**30:.0f} GiB)")


def _storage_job(ctx, d: Path, s3: S3Endpoint, docs: Path, seed: int, procs: list,
                 store_env: dict, state_env: dict) -> dict:
    """D's job: upload, submit, follow over a WebSocket, the sidecar, the
    checks on S3, the monitor daemon's start, promotion and ``/generate``."""
    from finetune_controller_tpu_torch.controller.objectstore import parse_uri
    from finetune_controller_tpu_torch.controller.syncer import matched_files

    api, scrape, rt, settings, on_loop, ctrl = ctx
    env = {**os.environ, **store_env, "PYTHONPATH": str(Path(__file__).resolve().parent)}
    dataset = api.ok("POST", "/datasets", files={"file": ("train.jsonl", docs.read_bytes())},
                     want=(201,))
    bucket, key = parse_uri(dataset["uri"])
    landed = s3.objects(bucket, key).get(key)
    if landed is None or landed.read_bytes() != docs.read_bytes():
        raise SmokeFailure(f"D: the uploaded dataset is not in the S3 bucket at {dataset['uri']}")
    # the pod's init container: storage_cli get of the dataset, beside the job
    fetched = d / "fetched" / "train.jsonl"
    get = subprocess.Popen(
        [sys.executable, "-m", "finetune_controller_tpu_torch.controller.storage_cli", "get",
         dataset["uri"], str(fetched)], env=env, stdout=(d / "get.log").open("wb"),
        stderr=subprocess.STDOUT)
    procs.append(get)
    t_submit = time.time()
    job_id = api.ok("POST", "/jobs", fields={
        "model_name": CONTROL_MODEL, "device": CONTROL_FLAVOR, "dataset_id": dataset["dataset_id"],
        "arguments": json.dumps(CONTROL_ARGS)})["job_id"]
    ws_base = api.base.replace("http://", "ws://")
    follow = _WsFollow(f"{ws_base}/logs/{job_id}?follow=true&search_string="
                       f"{D_SEARCH.replace(' ', '%20')}", api.token)
    artifacts = settings.state_path / "sandboxes" / job_id / "artifacts"
    sidecar_uri = f"obj://artifacts/sidecar/{job_id}"
    t_sidecar = time.time()
    sidecar = subprocess.Popen(
        [sys.executable, "-m", "finetune_controller_tpu_torch.controller.storage_cli", "sync",
         str(artifacts), sidecar_uri, "--interval", "2", "--until-done-file",
         str(artifacts / "done.txt")], env=env, stdout=(d / "sidecar.log").open("wb"),
        stderr=subprocess.STDOUT)
    procs.append(sidecar)
    # a second stream, follow=false&last_lines=20, opened while the job runs
    # (once it ends, the local backend drops its handle and a stream
    # answers "logs unavailable", as the reference's does), once the log
    # holds 20 lines or the last step's line
    tail: dict = {}
    last_step = f"step {CONTROL_ARGS['total_steps']} loss "

    def open_tail(job: dict) -> None:
        if tail or job["status"] != "running":
            return
        lines = api.ok("GET", f"/jobs/{job_id}/logs")["lines"]
        if len(lines) >= 20 or any(last_step in line for line in lines):
            tail.update(lines_before=len(lines), follow=_WsFollow(
                f"{ws_base}/logs/{job_id}?follow=false&last_lines=20", api.token))

    job, seen, logs = _follow_job(api, job_id, t_submit, "D", on_poll=open_tail)
    t_end = job["end_time"]  # the trainer process's exit
    follow.join(120)
    try:
        sidecar_rc = sidecar.wait(timeout=120)
    except subprocess.TimeoutExpired:
        raise SmokeFailure("D: the sidecar did not exit after done.txt") from None
    t_sidecar_exit = time.time()
    if sidecar_rc != 0:
        raise SmokeFailure(f"D: the sidecar exited {sidecar_rc}; see {d / 'sidecar.log'}")
    order = [st for st in ("queued", "running", "succeeded") if st in seen]
    records = _job_rows(api, job_id, CONTROL_ARGS["total_steps"], "D")

    # the stream: waiting lines, then the gated lines, equal to the REST log
    prefix = f"[{job['metadata']['trace_id'][:8]}#a1] "
    texts = [t for _, t in follow.messages]
    waiting = [t for t in texts if t.startswith("waiting:")]
    payload = [line for t in texts if not t.startswith("waiting:") for line in t.split("\n")]
    if not waiting or texts[:len(waiting)] != waiting:
        raise SmokeFailure(f"D: the stream did not start with waiting: lines: {texts[:3]}")
    if not payload or not all(line.startswith(prefix) for line in payload):
        raise SmokeFailure(f"D: stream payload lines without the prefix {prefix!r}: "
                           f"{payload[:3]}")
    gate = next((i for i, line in enumerate(logs) if D_SEARCH in line), None)
    if gate is None or [line[len(prefix):] for line in payload] != logs[gate:]:
        raise SmokeFailure(f"D: the stream's {len(payload)} payload lines differ from the "
                           f"REST log's {len(logs) - (gate or 0)} from the gate on")
    steps = sorted({int(m.group(1)) for line in payload
                    if (m := re.search(r"\bstep (\d+) loss ", line))})
    if steps != list(range(1, CONTROL_ARGS["total_steps"] + 1)):
        raise SmokeFailure(f"D: the stream's step lines are for steps {steps}")
    if follow.close is None or follow.close[2] < t_end:
        raise SmokeFailure(f"D: the stream closed {follow.close} before the job ended")
    first_payload_ts = next(ts for ts, t in follow.messages if not t.startswith("waiting:"))
    if not tail:
        raise SmokeFailure("D: the job's log never held 20 lines or its last step's line "
                           "while it ran")
    tail["follow"].join(60)
    tail_lines = [line[len(prefix):] for _, t in tail["follow"].messages
                  for line in t.split("\n")]
    # the log's last 20 lines (all of them, when it held fewer) when the
    # stream read them: a window of the final log that ends at or after
    # the length seen just before
    if not any(logs[max(0, k - 20):k] == tail_lines
               for k in range(tail["lines_before"], len(logs) + 1)):
        raise SmokeFailure(f"D: last_lines=20 over the WebSocket gave {len(tail_lines)} lines "
                           f"that are not the log's last 20: {tail_lines[:2]}")

    # S3: the artifact sync's prefix and the sidecar's hold the sandbox's
    # committed files byte for byte, and no checkpoint staging
    sandbox = _sha_tree(artifacts)
    committed = {p.relative_to(artifacts).as_posix() for p in matched_files(artifacts, None)}
    if set(sandbox) != committed:
        raise SmokeFailure(f"D: the sandbox holds staging {sorted(set(sandbox) - committed)}")
    for tag, uri in (("artifact sync", job["artifacts_uri"]), ("sidecar", sidecar_uri)):
        b, k = parse_uri(uri)
        on_s3 = {rel[len(k) + 1:]: h for rel, h in _sha_tree(d / "s3" / b).items()
                 if rel.startswith(k + "/")}
        # the controller adds the archived log and the assembled trace
        extra = {"logs.txt", "trace/trace.json"} if tag == "artifact sync" else set()
        mismatched = [rel for rel in sandbox if on_s3.get(rel) != sandbox[rel]]
        if mismatched or set(on_s3) - set(sandbox) - extra:
            raise SmokeFailure(f"D: the {tag}'s S3 prefix differs from the sandbox: "
                               f"{mismatched[:5]} {sorted(set(on_s3) - set(sandbox))[:5]}")
    done_ts = (artifacts / "done.txt").stat().st_mtime
    get_rc = get.wait(timeout=300)
    if get_rc != 0 or fetched.read_bytes() != docs.read_bytes():
        raise SmokeFailure(f"D: storage_cli get exited {get_rc}; see {d / 'get.log'}")

    # the profile on S3 lists the three flash kernels
    listing = api.ok("GET", f"/jobs/{job_id}/artifacts?list=1")["artifacts"]
    profiles = [a["path"] for a in listing if a["path"].startswith("profile/")
                and a["path"].endswith(".json")]
    if not profiles:
        raise SmokeFailure("D: the job's artifacts hold no profile/ trace")
    events = json.loads(on_loop(rt.store.get_bytes(f"{job['artifacts_uri']}/{profiles[0]}"),
                                300)).get("traceEvents", [])
    kernel_names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    seen_launches = {name: sum(sym in k for k in kernel_names)
                     for name, sym in FLASH_KERNEL_SYMBOLS.items()}
    missing = [n for n in FLASH_KERNELS if seen_launches.get(n, 0) <= 0]
    if missing:
        raise SmokeFailure(f"D: the job's profile lists no launch of {missing}")
    m = re.fullmatch(r"profile/steps_(\d+)-(\d+)\.pt\.trace\.json", profiles[0])
    profiled = list(range(int(m.group(1)) + 1, int(m.group(2)) + 1)) if m else []
    tokens = CONTROL_ARGS["batch_size"] * CONTROL_ARGS["seq_len"]
    step_ms = [tokens / r["tokens_per_sec"] * 1e3 for r in records]
    steady = sorted(ms for r, ms in zip(records, step_ms)
                    if r["step"] > 1 and r["step"] not in profiled)

    daemon = _start_monitor_daemon(d, {**state_env, **store_env})
    procs.append(daemon[0])
    promote_s, load_s, meta = _promote_and_load(api, job_id, "D")
    served = _generate_against_engine(ctx, job_id, meta["vocab_size"], CONTROL_PROMPTS,
                                      CONTROL_NEW_TOKENS, seed, "d")
    return {"daemon": daemon,
        "job_id": job_id, "statuses": order, "losses": [r["loss"] for r in records],
        "submit_to_running_s": seen["running"] - t_submit,
        "submit_to_first_ws_line_s": first_payload_ts - t_submit,
        "waiting_lines": len(waiting), "ws_payload_lines": len(payload), "ws_steps": steps,
        "ws_close_after_end_s": follow.close[2] - t_end,
        "tail_lines_before": tail["lines_before"], "tail_lines": len(tail_lines),
        "ms_per_step": step_ms, "profiled_steps": profiled,
        "ms_per_step_median": steady[len(steady) // 2],
        "median_over_steps": [r["step"] for r in records
                              if r["step"] > 1 and r["step"] not in profiled],
        "sidecar_s": t_sidecar_exit - t_sidecar,
        "sidecar_final_sync_s": t_sidecar_exit - done_ts,
        "sandbox_files": len(sandbox), "sandbox_bytes": tree_bytes(artifacts),
        "promote_s": promote_s, "model_load_s": load_s,
        "flash_launches_in_profile": seen_launches,
        **{k: served[k] for k in ("ttft_s", "decode_tokens_per_s", "requests_ok", "requests",
                                  "generated_tokens", "paged_launches")},
    }


def _start_monitor_daemon(d: Path, env: dict) -> tuple:
    """``monitor_main`` with ``env`` (``FTC_*``) over this process's: D's
    state service and S3, started once D's job has ended (its process start
    overlaps the promotion and ``/generate``), or K's, before its submit.
    Returns (the process, its metrics port, the start time)."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "finetune_controller_tpu_torch.controller.monitor_main"],
        env={**os.environ, "FTC_STATE_DIR": str(d / "monitor_state"),
             "FTC_JOB_MONITOR_INTERVAL_S": "0.5", **env,
             "FTC_MONITOR_METRICS_PORT": str(port),
             "PYTHONPATH": str(Path(__file__).resolve().parent)},
        stdout=(d / "monitor.log").open("wb"), stderr=subprocess.STDOUT)
    return proc, port, time.perf_counter()


def _check_monitor_daemon(daemon: tuple, d: Path, api, job_id: str, before: dict) -> dict:
    """The daemon's ``/metrics`` carries ``process="monitor"``; after two
    more ticks the job's record is ``before``; SIGTERM stops the daemon with
    exit code 0 within ``D_STOP_S``."""
    proc, port, t0 = daemon
    try:
        ticks, first, text = 0.0, None, ""
        while first is None or ticks < first + 2:
            if proc.poll() is not None or time.perf_counter() - t0 > 180:
                raise SmokeFailure(f"D: the monitor daemon exited {proc.poll()} or did not "
                                   f"tick twice; see {d / 'monitor.log'}")
            try:
                status, text = _http_ok(f"http://127.0.0.1:{port}/metrics")
                if status == 200:
                    ticks = _prom_value(text, "ftc_monitor_ticks_total")
                    first = ticks if first is None else first
            except OSError:
                pass
            time.sleep(0.2)
        if not re.search(r'^ftc_build_info\{process="monitor"', text, re.M):
            raise SmokeFailure("D: the monitor daemon's /metrics has no "
                               "ftc_build_info{process=\"monitor\"}")
        if api.ok("GET", f"/jobs/{job_id}") != before:
            raise SmokeFailure("D: the job's record changed under the monitor daemon")
        t_stop = time.perf_counter()
        _stop(proc, "D: the monitor daemon")
        return {"ticks": ticks, "stop_s": time.perf_counter() - t_stop}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


#: phase K: the k8s backend against :class:`KubeEndpoint` (the kube API and
#: a one-node kubelet in this script), beside D's S3 endpoint and state
#: service; the monitor daemon alone reconciles the live job
K_NAMESPACE = "ftc"
#: K's depth, set by an operator plugin (``LLAMA_CUT_PLUGIN``): K adds a
#: trainer pod, a sidecar and a daemon to a run that must end inside 1200 s
K_LAYERS = 8
K_ARGS = {**{k: v for k, v in CONTROL_ARGS.items() if k != "profile_steps"},
          "total_steps": 5, "checkpoint_every": 5}
#: the greedy ``/generate`` requests after promotion from S3 (prompt tokens)
K_PROMPTS = (20, 377)
#: the most K may write: the pod's data volume (the dataset and the job's
#: artifacts), their copy on S3, two stagings of the promoted checkpoint
K_DISK_BYTES = int(2.5 * 2**30)
#: ``terminationGracePeriodSeconds``' default: SIGTERM, then SIGKILL after it
K_GRACE_S = 30.0
LLAMA_CUT_PLUGIN = '''"""``llama3-8b-lora`` at {layers} of its 32 layers."""

from finetune_controller_tpu_torch.controller.examples import Llama3_8B_LoRA


class Llama3_8B_LoRA_Cut(Llama3_8B_LoRA):
    def build_trainer_spec(self, job_id, artifacts_dir, **kw):
        spec = super().build_trainer_spec(job_id, artifacts_dir, **kw)
        spec["model"].setdefault("overrides", {{}})["n_layers"] = {layers}
        return spec
'''


def _rfc3339(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(ts)) + f".{int(ts % 1 * 1e6):06d}Z"


class KubeEndpoint:
    """The part of the Kubernetes API that the port's ``HttpKubeClient``
    uses, and a one-node kubelet, on the port's ``controller/web.py`` on
    ``127.0.0.1`` and a thread of its own.

    The API: create (``POST`` of a collection; 409 with a ``Status`` when
    the name exists, 422 when the JobSet fails the operators' schema
    checks), get (404 with a ``Status``), list by ``labelSelector``
    (``{"items": [...]}``), delete, and a pod's log (``container``,
    ``follow``, ``tailLines``; a 400 while the container waits to start, as
    the API server answers).  The objects are kept in the port's
    ``InMemoryKubeClient``, so its JobSet schema checks apply, and its
    ``kueue_tick`` admits suspended JobSets FIFO under a quota of ``gpus``
    ``nvidia.com/gpu`` and materialises their pods.

    The kubelet runs each new pod's containers as processes of this host:
    the ConfigMap volume's data is written into a directory of the pod, and
    each ``emptyDir`` is a directory of the pod.  Its one liberty: in
    commands, env values and ConfigMap data, a volume's ``mountPath``
    (``/data``, ``/etc/ftc``) is rewritten to that directory, since the
    processes share this host's file system.  ``fieldRef`` env values
    resolve from the pod's annotations and labels; ``python`` is this
    interpreter, through a shim on ``PATH``; the env is what the manifest
    gives (no ``FTC_*`` or ``AWS_*`` of this process) on top of the image's
    (``PYTHONUNBUFFERED=1``, the checkout on ``PYTHONPATH``); a container
    that requests ``nvidia.com/gpu`` gets its granted cards in
    ``CUDA_VISIBLE_DEVICES``, any other none.  Native sidecar semantics:
    the init containers run in order, a regular one to completion and a
    sidecar (``restartPolicy: Always``) started and left running; then the
    main containers; when they have exited, each sidecar gets SIGTERM, and
    SIGKILL after ``K_GRACE_S``; the pod completes once the sidecars have
    exited, and only then does its JobSet get ``Completed`` (or ``Failed``)
    with an RFC 3339 ``lastTransitionTime`` (its ``startTime`` is the
    admission's).  A DELETE of a JobSet deletes its pods and SIGTERMs their
    processes (SIGKILL after ``K_GRACE_S``).  ``timeline[jobset]`` keeps
    the times of each step, ``pods[name]`` each pod's directories and exit
    codes."""

    def __init__(self, root: Path, *, gpus: int = 1):
        import threading

        from finetune_controller_tpu_torch.controller import web
        from finetune_controller_tpu_torch.controller.backends.k8s import InMemoryKubeClient

        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.kube = InMemoryKubeClient(quota_chips=gpus)
        self.lock = threading.RLock()
        self.free_cards = list(range(gpus))
        self.pods: dict[str, _KubeletPod] = {}
        self.timeline: dict[str, dict] = {}
        self.requests: dict[str, int] = {}
        shim = self.root / "bin" / "python"
        shim.parent.mkdir(exist_ok=True)
        shim.write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        shim.chmod(0o755)
        self.base_env = {k: v for k, v in os.environ.items()
                         if not k.startswith(("FTC_", "AWS_", "CUDA_VISIBLE_DEVICES"))}
        repo = str(Path(__file__).resolve().parent)
        self.base_env.update(
            PATH=f"{shim.parent}:{os.environ.get('PATH', '')}", PYTHONUNBUFFERED="1",
            PYTHONPATH=os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH"))
                                       if p))
        app = web.Application(client_max_size=16 << 20)
        for method in ("GET", "POST", "DELETE"):
            app.router.add_route(method, "/{path:.*}", self._handle)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, name="kube-endpoint",
                                       daemon=True)
        self.thread.start()
        self.runner = web.AppRunner(app)
        self._call(self.runner.setup())
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        self._call(site.start())
        self.endpoint = f"http://127.0.0.1:{site.port}"
        self._stop = threading.Event()
        self.kubelet = threading.Thread(target=self._kubelet, name="kubelet", daemon=True)
        self.kubelet.start()

    def _call(self, coro, timeout=60):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self) -> None:
        self._stop.set()
        self.kubelet.join(30)
        for pod in list(self.pods.values()):
            pod.kill(grace_s=0)
        for pod in list(self.pods.values()):
            if pod.thread is not None:
                pod.thread.join(30)
        self._call(self.runner.cleanup())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()

    def jobset(self, name: str) -> dict | None:
        with self.lock:
            return next((o for o in self.kube._jobsets() if o["metadata"]["name"] == name),
                        None)

    def has(self, kind: str, name: str) -> bool:
        with self.lock:
            return any(path.endswith(f"/{kind}") and n == name for path, n in self.kube.objects)

    # -- the API ---------------------------------------------------------------

    @staticmethod
    def _status(code: int, reason: str, message: str):
        from finetune_controller_tpu_torch.controller import web

        return web.json_response({"kind": "Status", "apiVersion": "v1", "status": "Failure",
                                  "reason": reason, "message": message, "code": code},
                                 status=code)

    async def _handle(self, request):
        from finetune_controller_tpu_torch.controller import web
        from finetune_controller_tpu_torch.controller.backends.base import BackendError

        key = f"{request.method} {request.path.rsplit('/', 1)[0]}"
        self.requests[key] = self.requests.get(key, 0) + 1
        m = re.fullmatch(r"/api/v1/namespaces/[^/]+/pods/([^/]+)/log", request.path)
        if m and request.method == "GET":
            return await self._log(request, m.group(1))
        m = re.fullmatch(r"(/api/v1/namespaces/[^/]+/[^/]+|/apis/[^/]+/[^/]+/namespaces/[^/]+"
                         r"/[^/]+)(?:/([^/]+))?", request.path)
        if m is None:
            return self._status(404, "NotFound", f"no route {request.path}")
        coll, name = m.groups()
        if request.method == "POST" and name is None:
            body = await request.json()
            with self.lock:
                try:
                    obj = await self.kube.create(coll, body)
                except BackendError as e:
                    if "already exists" in str(e):
                        return self._status(409, "AlreadyExists", str(e))
                    return self._status(422, "Invalid", str(e))
                if obj.get("kind") == "JobSet":
                    self.timeline[obj["metadata"]["name"]] = {"created": time.time()}
                text = json.dumps(obj)
            return web.json_response(text=text, status=201)
        if request.method == "GET" and name is None:
            with self.lock:
                items = await self.kube.list(coll, request.query.get("labelSelector", ""))
                text = json.dumps({"kind": "List", "apiVersion": "v1", "items": items})
            return web.json_response(text=text)
        if request.method == "GET":
            with self.lock:
                obj = await self.kube.get(coll, name)
                text = None if obj is None else json.dumps(obj)
            if text is None:
                return self._status(404, "NotFound", f"{coll}/{name} not found")
            return web.json_response(text=text)
        if request.method == "DELETE" and name is not None:
            with self.lock:
                obj = self.kube.objects.pop((coll, name), None)
                if obj is not None and coll.endswith("/jobsets"):
                    self._delete_jobset(name)
            if obj is None:
                return self._status(404, "NotFound", f"{coll}/{name} not found")
            return web.json_response({"kind": "Status", "apiVersion": "v1",
                                      "status": "Success"})
        return self._status(405, "MethodNotAllowed", f"{request.method} {request.path}")

    def _delete_jobset(self, name: str) -> None:
        """The JobSet's pods go with it (the garbage collector's cascade),
        their processes SIGTERMed, SIGKILLed after ``K_GRACE_S``."""
        self.timeline.setdefault(name, {})["deleted"] = time.time()
        for key in [k for k, o in self.kube.objects.items() if k[0].endswith("/pods")
                    and o["metadata"]["labels"].get("jobset.sigs.k8s.io/jobset-name") == name]:
            del self.kube.objects[key]
        for pod in self.pods.values():
            if pod.jobset == name:
                pod.kill(grace_s=K_GRACE_S)

    async def _log(self, request, name: str):
        from finetune_controller_tpu_torch.controller import web

        with self.lock:
            pod = self.pods.get(name)
            listed = any(k[0].endswith("/pods") and k[1] == name for k in self.kube.objects)
        if pod is None or not listed:
            return self._status(404, "NotFound", f'pods "{name}" not found')
        container = request.query.get("container") or pod.main[0]
        path = pod.log_path(container)
        if container not in pod.started:
            return self._status(400, "BadRequest", f'container "{container}" in pod "{name}" '
                                "is waiting to start: PodInitializing")
        follow = request.query.get("follow") == "true"
        tail = request.query.get("tailLines")
        resp = web.StreamResponse(headers={"Content-Type": "text/plain"})
        await resp.prepare(request)
        with path.open("rb") as f:
            data = await asyncio.to_thread(f.read)
            if tail is not None:
                lines = data.splitlines(keepends=True)
                data = b"".join(lines[len(lines) - int(tail):] if int(tail) else [])
            await resp.write(data)
            while follow:
                exited = container in pod.exit_codes
                chunk = await asyncio.to_thread(f.read)
                if chunk:
                    await resp.write(chunk)
                elif exited:
                    break
                else:
                    await asyncio.sleep(0.05)
        await resp.write_eof()
        return resp

    # -- the kubelet -----------------------------------------------------------

    def _kubelet(self) -> None:
        import threading

        while not self._stop.wait(0.1):
            with self.lock:
                self.kube.kueue_tick()
                now = time.time()
                for js in self.kube._jobsets():
                    times = self.timeline.setdefault(js["metadata"]["name"], {})
                    if not js["spec"].get("suspend") and "admitted" not in times:
                        times["admitted"] = now
                        js.setdefault("status", {})["startTime"] = _rfc3339(now)
                starts = []
                for (path, name), obj in list(self.kube.objects.items()):
                    if not path.endswith("/pods") or "uid" in obj["metadata"]:
                        continue
                    meta = obj["metadata"]
                    meta["uid"] = os.urandom(8).hex()
                    # JobSet puts the indexes on the pod as annotations too
                    meta["annotations"] = {k: v for k, v in meta["labels"].items()
                                           if k != "jobset.sigs.k8s.io/jobset-name"}
                    js = self.jobset(meta["labels"]["jobset.sigs.k8s.io/jobset-name"])
                    spec = json.loads(json.dumps(
                        js["spec"]["replicatedJobs"][0]["template"]["spec"]["template"]["spec"]))
                    cms = {n: json.loads(json.dumps(o)) for (p, n), o in self.kube.objects.items()
                           if p == f"/api/v1/namespaces/{meta['namespace']}/configmaps"}
                    gpus = sum(int(c.get("resources", {}).get("limits", {})
                                   .get("nvidia.com/gpu", 0)) for c in spec["containers"])
                    cards, self.free_cards = self.free_cards[:gpus], self.free_cards[gpus:]
                    pod = _KubeletPod(self, meta, spec, cms, cards)
                    self.pods[name] = pod
                    self.timeline[pod.jobset].setdefault("pod_started", now)
                    starts.append(pod)
            for pod in starts:
                pod.thread = threading.Thread(target=self._run, args=(pod,), name=pod.name,
                                              daemon=True)
                pod.thread.start()

    def _run(self, pod: "_KubeletPod") -> None:
        try:
            phase, message = pod.run()
        except Exception as e:  # a kubelet fault fails the pod, not the thread
            phase, message = "Failed", f"kubelet: {type(e).__name__}: {e}"
            pod.kill(grace_s=0)
            for proc in pod.procs.values():
                proc.wait()
        now = time.time()
        with self.lock:
            self.free_cards += pod.cards
            pod.phase = phase
            obj = self.kube.objects.get((f"/api/v1/namespaces/{pod.namespace}/pods", pod.name))
            if obj is not None:
                obj["status"]["phase"] = phase
            times = self.timeline[pod.jobset]
            times.update({k: v for k, v in pod.times.items() if k not in times})
            js = self.jobset(pod.jobset)
            siblings = [p for p in self.pods.values() if p.jobset == pod.jobset]
            if js is None or self.kube._is_terminal(js) or any(p.phase is None
                                                              for p in siblings):
                return
            failed = [p.name for p in siblings if p.phase != "Succeeded"]
            self.kube.finish_jobset(pod.jobset, failed=bool(failed),
                                    message=f"pods failed: {failed}: {message}" if failed
                                    else "jobset completed successfully")
            cond = js["status"]["conditions"][-1]
            cond.update(reason="FailedJobs" if failed else "AllJobsCompleted",
                        lastTransitionTime=_rfc3339(now))
            times["completed"] = now


class _KubeletPod:
    """One pod of :class:`KubeEndpoint`'s kubelet: its volumes, env and
    containers."""

    def __init__(self, endpoint: "KubeEndpoint", meta: dict, spec: dict, configmaps: dict,
                 cards: list[int]):
        self.name, self.namespace = meta["name"], meta["namespace"]
        self.jobset = meta["labels"]["jobset.sigs.k8s.io/jobset-name"]
        self.meta, self.spec, self.cards = meta, spec, cards
        self.base_env = endpoint.base_env
        self.dir = endpoint.root / "pods" / f"{self.name}-{meta['uid']}"
        (self.dir / "logs").mkdir(parents=True)
        self.main = [c["name"] for c in spec["containers"]]
        self.procs: dict[str, subprocess.Popen] = {}
        self.started: set[str] = set()
        self.exit_codes: dict[str, int] = {}
        self.times: dict[str, float] = {}
        self.phase: str | None = None
        self.thread = None
        self._killed_at: float | None = None
        self._grace_s = K_GRACE_S
        self.volumes: dict[str, Path] = {}
        for vol in spec.get("volumes", []):
            self.volumes[vol["name"]] = self.dir / "volumes" / vol["name"]
            self.volumes[vol["name"]].mkdir(parents=True)
        self.mounts: dict[str, Path] = {}
        for c in spec.get("initContainers", []) + spec["containers"]:
            for vm in c.get("volumeMounts", []):
                self.mounts[vm["mountPath"]] = self.volumes[vm["name"]]
        self._mount_re = re.compile(
            r"(?<![\w.\-/])(" + "|".join(re.escape(m) for m in sorted(self.mounts, key=len,
                                                                      reverse=True))
            + r")(?=/|$|[^\w.\-])") if self.mounts else None
        self.configmaps = configmaps

    def rewrite(self, text: str) -> str:
        """A volume's ``mountPath`` in ``text`` -> the pod's directory for it."""
        if self._mount_re is None:
            return text
        return self._mount_re.sub(lambda m: str(self.mounts[m.group(1)]), text)

    def log_path(self, container: str) -> Path:
        return self.dir / "logs" / f"{container}.log"

    def _field(self, path: str) -> str:
        m = re.fullmatch(r"metadata\.(annotations|labels)\['([^']+)'\]", path)
        if m:
            return self.meta.get(m.group(1), {}).get(m.group(2), "")
        if path in ("metadata.name", "metadata.namespace", "metadata.uid"):
            return self.meta[path.split(".")[1]]
        raise RuntimeError(f"unsupported fieldRef {path!r}")

    def _start(self, c: dict) -> subprocess.Popen:
        env = dict(self.base_env)
        for e in c.get("env", []):
            if "value" in e:
                env[e["name"]] = self.rewrite(str(e["value"]))
            else:
                env[e["name"]] = self._field(e["valueFrom"]["fieldRef"]["fieldPath"])
        wants_gpu = int(c.get("resources", {}).get("limits", {}).get("nvidia.com/gpu", 0))
        env["CUDA_VISIBLE_DEVICES"] = ",".join(map(str, self.cards)) if wants_gpu else ""
        argv = [self.rewrite(a) for a in c["command"] + c.get("args", [])]
        with self.log_path(c["name"]).open("ab") as log_f:
            proc = subprocess.Popen(argv, env=env, cwd=self.dir, stdout=log_f,
                                    stderr=subprocess.STDOUT, start_new_session=True)
        self.procs[c["name"]] = proc
        self.started.add(c["name"])
        self.times.setdefault(f"{c['name']}_start", time.time())
        return proc

    def _wait(self, names: list[str]) -> None:
        """Until every named container has exited; a kill's grace ends in
        SIGKILL."""
        while True:
            for n in names:
                if n not in self.exit_codes and self.procs[n].poll() is not None:
                    self.exit_codes[n] = self.procs[n].returncode
                    self.times[f"{n}_exit"] = time.time()
            if all(n in self.exit_codes for n in names):
                return
            if self._killed_at is not None and time.time() > self._killed_at + self._grace_s:
                for n in names:
                    if n not in self.exit_codes:
                        with contextlib.suppress(ProcessLookupError):
                            os.killpg(self.procs[n].pid, 9)
            time.sleep(0.05)

    def kill(self, grace_s: float) -> None:
        """SIGTERM every running container's process group; SIGKILL once
        ``grace_s`` has passed."""
        if self._killed_at is None:
            self._killed_at = time.time()
        self._grace_s = min(self._grace_s, grace_s)
        for n, proc in list(self.procs.items()):
            if proc.poll() is None:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, 15 if grace_s else 9)

    def run(self) -> tuple[str, str]:
        for vol in self.spec.get("volumes", []):
            if "configMap" in vol:
                cm = self.configmaps.get(vol["configMap"]["name"])
                if cm is None:
                    return "Failed", f"configmap {vol['configMap']['name']!r} not found"
                for key, value in cm.get("data", {}).items():
                    (self.volumes[vol["name"]] / key).write_text(self.rewrite(value))
        sidecars: list[str] = []
        for c in self.spec.get("initContainers", []):
            if self._killed_at is not None:
                break
            self._start(c)
            if c.get("restartPolicy") == "Always":
                sidecars.append(c["name"])
                continue
            self._wait([c["name"]])
            if self.exit_codes[c["name"]] != 0:
                self._stop_sidecars(sidecars)
                return "Failed", f"init container {c['name']} exited {self.exit_codes[c['name']]}"
        if self._killed_at is None:
            for c in self.spec["containers"]:
                self._start(c)
            self._wait(self.main)
        self._stop_sidecars(sidecars)
        bad = {n: rc for n, rc in self.exit_codes.items() if n in self.main and rc != 0}
        if self._killed_at is not None or bad or len(self.exit_codes) < len(self.procs):
            return "Failed", f"containers exited {bad}" if bad else "deleted"
        return "Succeeded", ""

    def _stop_sidecars(self, names: list[str]) -> None:
        """SIGTERM each running sidecar (the main containers have exited),
        SIGKILL after the grace."""
        for n in reversed(names):
            if self.procs[n].poll() is None:
                self.times[f"{n}_sigterm"] = time.time()
                with contextlib.suppress(ProcessLookupError):
                    self.procs[n].send_signal(15)
        deadline = time.time() + self._grace_s
        while any(n not in self.exit_codes and self.procs[n].poll() is None for n in names):
            if time.time() > deadline:
                for n in names:
                    with contextlib.suppress(ProcessLookupError):
                        os.killpg(self.procs[n].pid, 9)
            time.sleep(0.05)
        for n in names:
            if n not in self.exit_codes:
                self.exit_codes[n] = self.procs[n].wait()
                self.times[f"{n}_exit"] = time.time()


def _wait_until(predicate, timeout_s: float, what: str, tag: str = "K"):
    """Poll ``predicate`` every 0.1 s until it returns a true value."""
    t0 = time.time()
    while True:
        value = predicate()
        if value:
            return value
        if time.time() - t0 > timeout_s:
            raise SmokeFailure(f"{tag}: {what} within {timeout_s:.0f} s")
        time.sleep(0.1)


def k8s_phase(work, seed: int, d: Path, s3: S3Endpoint, state_env: dict,
              store_env: dict, card: str) -> dict:
    """K: the k8s backend on the card.  :class:`KubeEndpoint` serves the
    kube API and runs the pods; D's S3 endpoint and state service hold the
    objects and the state.  The port's server runs in this process with
    ``FTC_BACKEND=k8s``, ``FTC_KUBE_API_URL`` the endpoint and no monitor of
    its own (``FTC_MONITOR_IN_PROCESS=false``); ``monitor_main`` runs as a
    process of its own from before the submit.  T2's documents are
    uploaded, and ``llama3-8b-lora`` (full width, ``K_LAYERS`` of 32 layers
    by an operator plugin, ``K_ARGS``: 5 steps, no profiler window) is
    submitted on ``h100``: a ConfigMap and a suspended JobSet, admitted
    under the endpoint's quota of one ``nvidia.com/gpu``; its pod fetches
    the dataset from S3, runs the trainer on the card beside the
    artifact-sync sidecar, which gets SIGTERM when the trainer exits.
    Checked (:func:`_k8s_job`): the JobSet requests ``nvidia.com/gpu: 1``; a
    second job submitted meanwhile stays suspended and QUEUED, is the queue
    snapshot, and is cancelled while queued, its JobSet and ConfigMap
    deleted and no pod started; the daemon alone moves the job RUNNING ->
    SUCCEEDED with its ``training_duration``, then deletes its JobSet and
    ConfigMap; the WebSocket follow (``GET {prefix}/logs/{id}``, through the
    pod log) gives the trainer's log line for line and closes after the
    trainer exited; the sidecar exits 0 and the S3 prefix equals the pod's
    artifacts byte for byte, ``done.txt`` included; the trainer's
    ``kernel_launches`` events count each flash kernel; after promotion
    from S3, 2 ``/generate`` answers equal an in-process engine, the paged
    count rising.  K writes at most ``K_DISK_BYTES``; its line names
    ``card`` (``nvidia-smi``'s name and power limit)."""
    t_phase = time.perf_counter()
    disk0 = DISK.written()
    k = Path(d) / "k8s"
    shutil.rmtree(k, ignore_errors=True)
    (k / "plugins").mkdir(parents=True)
    (k / "plugins" / "llama_depth.py").write_text(LLAMA_CUT_PLUGIN.format(layers=K_LAYERS))
    docs = Path(work) / "train.jsonl"
    if not docs.exists():
        write_documents(docs, seed)
    kube = KubeEndpoint(k / "kube", gpus=1)
    backend_env = {"FTC_BACKEND": "k8s", "FTC_KUBE_API_URL": kube.endpoint,
                   "FTC_NAMESPACE": K_NAMESPACE, "FTC_MONITOR_IN_PROCESS": "false"}
    daemon = None
    try:
        daemon = _start_monitor_daemon(k, {
            **state_env, **store_env, **backend_env, "FTC_RETRY_MAX_ATTEMPTS": "0",
            "FTC_ARTIFACT_SYNC_INTERVAL_S": CONTROL_ENV["FTC_ARTIFACT_SYNC_INTERVAL_S"]})
        with control_plane(k / "api", {**CONTROL_ENV, **state_env, **store_env, **backend_env},
                           plugin_dir=k / "plugins") as ctx:
            record = _k8s_job(ctx, kube, s3, daemon, docs, seed)
        t_stop = time.perf_counter()
        _stop(daemon[0], "K: the monitor daemon")
        record["daemon_stop_s"] = time.perf_counter() - t_stop
    finally:
        kube.close()
        if daemon is not None and daemon[0].poll() is None:
            daemon[0].kill()
            daemon[0].wait()
    written = DISK.written() - disk0
    record.update(bytes_written=written, phase_s=time.perf_counter() - t_phase,
                  kube_requests=kube.requests, card=card)
    sigterm_s = record["sidecar_sigterm_to_exit_s"]
    log(f"K: {CONTROL_MODEL} ({K_LAYERS} of 32 layers) on {CONTROL_FLAVOR} through the k8s "
        f"backend: a JobSet requesting {record['gpu_resource']}: 1, admitted "
        f"{record['submit_to_admitted_s']:.2f} s after the submit; "
        f"{' -> '.join(record['statuses'])} by the monitor daemon alone (the server's monitor "
        f"ticked {record['server_monitor_ticks']} times, the daemon's "
        f"{record['daemon_ticks']:.0f}), training_duration {record['training_duration']:.1f} s, "
        f"Completed -> SUCCEEDED {record['completed_to_succeeded_s']:.2f} s, JobSet and "
        f"ConfigMap deleted {record['completed_to_deleted_s']:.2f} s after Completed; the "
        f"second job QUEUED at position 1, the queue snapshot {record['queue_snapshot']}, "
        f"cancelled while queued (no pod); submit -> first WebSocket line "
        f"{record['submit_to_first_ws_line_s']:.1f} s, {record['waiting_lines']} waiting: lines "
        f"then the trainer's {record['ws_payload_lines']} lines, closed "
        f"{record['ws_close_after_trainer_exit_s']:.2f} s after the trainer exited; "
        f"{record['ms_per_step_median']:.0f} ms/step median of steps "
        f"{record['median_over_steps']}; the sidecar {record['sidecar_end']}, exit 0, "
        f"SIGTERM -> exit {'not measured (no SIGTERM)' if sigterm_s is None else f'{sigterm_s:.3f} s'}; S3 equal to the pod's "
        f"{record['pod_artifact_files']} artifact files ({record['pod_artifact_bytes'] / 1e9:.3f}"
        f" GB) with done.txt; flash launches in the pod {record['flash_launches']}; promote "
        f"{record['promote_s']:.2f} s, load {record['model_load_s']:.1f} s; "
        f"{record['requests_ok']}/{record['requests']} /generate equal to the in-process "
        f"engine, paged launches {record['paged_launches']}; K wrote {written / 1e9:.2f} GB in "
        f"{record['phase_s']:.1f} s ({card})")
    if written > K_DISK_BYTES:
        raise SmokeFailure(f"K: {written / 2**30:.2f} GiB written (budget "
                           f"{K_DISK_BYTES / 2**30:.1f} GiB)")
    return record


def _k8s_job(ctx, kube: KubeEndpoint, s3: S3Endpoint, daemon: tuple, docs: Path,
             seed: int) -> dict:
    """K's jobs: the live one, the queued one, the checks, promotion and
    ``/generate``."""
    from finetune_controller_tpu_torch.controller.objectstore import parse_uri
    from finetune_controller_tpu_torch.controller.syncer import matched_files

    api, scrape, rt, settings, on_loop, ctrl = ctx
    fields = {"model_name": CONTROL_MODEL, "device": CONTROL_FLAVOR,
              "arguments": json.dumps(K_ARGS)}
    dataset = api.ok("POST", "/datasets", files={"file": ("train.jsonl", docs.read_bytes())},
                     want=(201,))
    fields["dataset_id"] = dataset["dataset_id"]
    t_submit = time.time()
    job_id = api.ok("POST", "/jobs", fields=fields)["job_id"]
    follow = _WsFollow(f"{api.base.replace('http://', 'ws://')}/logs/{job_id}?follow=true",
                       api.token, tag="K")
    admitted = _wait_until(lambda: kube.timeline.get(job_id, {}).get("admitted"), 120,
                           "the JobSet was not admitted")
    manifest = json.loads(json.dumps(kube.jobset(job_id)))
    pod_spec = manifest["spec"]["replicatedJobs"][0]["template"]["spec"]["template"]["spec"]
    trainer = next(c for c in pod_spec["containers"] if c["name"] == "trainer")
    resource = "nvidia.com/gpu" if DEVICE == "cuda" else "cpu"
    gpu = (trainer["resources"]["requests"].get(resource),
           trainer["resources"]["limits"].get(resource))
    if gpu != ("1", "1"):
        raise SmokeFailure(f"K: the trainer requests/limits {resource} {gpu}")
    sync_cmd = next(c for c in pod_spec["initContainers"]
                    if c["name"] == "artifact-sync")["command"]
    patterns = [sync_cmd[i + 1] for i, a in enumerate(sync_cmd) if a == "--pattern"]

    # a second job while the first runs: suspended, QUEUED at position 1,
    # the queue snapshot; cancelled while queued, it leaves nothing behind
    second = api.ok("POST", "/jobs", fields=fields)["job_id"]
    _wait_until(lambda: api.ok("GET", f"/jobs/{second}").get("queue_position") == 1, 60,
                "the second job was not QUEUED at position 1 by the daemon")
    queued = api.ok("GET", f"/jobs/{second}")
    snapshot = on_loop(rt.backend.queue_snapshot(), 60)
    if queued["status"] != "queued" or snapshot != [second] or not kube.jobset(second)[
            "spec"]["suspend"]:
        raise SmokeFailure(f"K: the second job is {queued['status']}, the queue snapshot "
                           f"{snapshot}")
    api.ok("POST", f"/jobs/{second}/cancel")
    if kube.has("jobsets", second) or kube.has("configmaps", f"{second}-spec") or (
            "admitted" in kube.timeline.get(second, {})):
        raise SmokeFailure("K: the cancelled job's JobSet or ConfigMap is left, or it was "
                           "admitted")

    seen: dict[str, float] = {}
    while time.time() - t_submit < CONTROL_JOB_TIMEOUT_S:
        job = api.ok("GET", f"/jobs/{job_id}")
        seen.setdefault(job["status"], time.time())
        if job["status"] in ("succeeded", "failed", "cancelled"):
            break
        time.sleep(0.25)
    pod = kube.pods.get(f"{job_id}-slice-0-0")
    if job["status"] != "succeeded" or "running" not in seen or pod is None:
        tail = pod.log_path("trainer").read_text()[-3000:] if pod else ""
        raise SmokeFailure(f"K: job {job_id} ended {job['status']} (seen {sorted(seen)}, "
                           f"{job.get('metadata')}); trainer log tail:\n{tail}")
    times = kube.timeline[job_id]
    if rt.monitor.ticks != 0 or settings.monitor_in_process:
        raise SmokeFailure(f"K: the server's own monitor ticked {rt.monitor.ticks} times")
    status, text = _http_ok(f"http://127.0.0.1:{daemon[1]}/metrics")
    daemon_ticks = _prom_value(text, "ftc_monitor_ticks_total") if status == 200 else 0.0
    if daemon_ticks <= 0 or daemon[0].poll() is not None:
        raise SmokeFailure(f"K: the monitor daemon ticked {daemon_ticks} times")
    expect = times["completed"] - admitted
    if abs((job.get("training_duration") or 0) - expect) > 0.01:
        raise SmokeFailure(f"K: training_duration {job.get('training_duration')} is not "
                           f"Completed - admitted ({expect:.3f} s)")
    _, at = _timeline(api, job_id, ("submitted", "running", "succeeded"), "K")
    deleted = _wait_until(lambda: not kube.has("jobsets", job_id) and not kube.has(
        "configmaps", f"{job_id}-spec") and time.time(), 30,
        "the daemon did not delete the JobSet and ConfigMap")

    # the log over the WebSocket: waiting lines, then the trainer's log
    follow.join(120)
    prefix = f"[{job['metadata']['trace_id'][:8]}#a1] "
    texts = [t for _, t in follow.messages]
    waiting = [t for t in texts if t.startswith("waiting:")]
    payload = [line for t in texts if not t.startswith("waiting:") for line in t.split("\n")]
    trainer_log = pod.log_path("trainer").read_text().splitlines()
    if texts[:len(waiting)] != waiting or [line[len(prefix):] for line in payload] != \
            trainer_log or not all(line.startswith(prefix) for line in payload):
        raise SmokeFailure(f"K: the stream's {len(payload)} lines differ from the trainer's "
                           f"{len(trainer_log)}: {payload[:2]} {trainer_log[:2]}")
    steps = sorted({int(m.group(1)) for line in trainer_log
                    if (m := re.search(r"\bstep (\d+) loss ", line))})
    if steps != list(range(1, K_ARGS["total_steps"] + 1)):
        raise SmokeFailure(f"K: the trainer's log has step lines for {steps}")
    if follow.close is None or follow.close[2] < times["trainer_exit"]:
        raise SmokeFailure(f"K: the stream closed {follow.close} before the trainer exited")
    first_payload_ts = next(ts for ts, t in follow.messages if not t.startswith("waiting:"))

    # the sidecar, and the S3 prefix against the pod's artifacts
    if pod.exit_codes != {"dataset-fetch": 0, "artifact-sync": 0, "trainer": 0}:
        raise SmokeFailure(f"K: the pod's containers exited {pod.exit_codes}")
    artifacts = pod.volumes["data"] / "artifacts"
    matched = {p.relative_to(artifacts).as_posix() for p in matched_files(artifacts, patterns)}
    local = {rel: h for rel, h in _sha_tree(artifacts).items() if rel in matched}
    b, key = parse_uri(job["artifacts_uri"])
    on_s3 = {rel[len(key) + 1:]: h for rel, h in _sha_tree(s3.root / b).items()
             if rel.startswith(key + "/")}
    mismatched = [rel for rel in local if on_s3.get(rel) != local[rel]]
    if mismatched or set(on_s3) - set(local) - {"trace/trace.json"} or "done.txt" not in local:
        raise SmokeFailure(f"K: the S3 prefix differs from the pod's artifacts: {mismatched[:5]}"
                           f" {sorted(set(on_s3) - set(local))[:5]}")
    if (pod.volumes["data"] / "dataset" / "train.jsonl").read_bytes() != docs.read_bytes():
        raise SmokeFailure("K: the dataset-fetch init container's copy differs")
    events = [json.loads(line) for line in
              (s3.root / b / key / "events.jsonl").read_text().splitlines() if line.strip()]
    launches = next((e["attrs"]["kernel_launches"] for e in reversed(events)
                     if (e.get("attrs") or {}).get("kernel_launches")), {})
    if DEVICE == "cuda" and min(launches.get(n, 0) for n in FLASH_KERNELS) <= 0:
        raise SmokeFailure(f"K: the trainer's kernel_launches events show {launches}")
    records = _job_rows(api, job_id, K_ARGS["total_steps"], "K")
    tokens = K_ARGS["batch_size"] * K_ARGS["seq_len"]
    step_ms = [tokens / r["tokens_per_sec"] * 1e3 for r in records]
    steady = sorted(ms for r, ms in zip(records, step_ms) if r["step"] > 1)
    sigterm = times.get("artifact-sync_sigterm")

    promote_s, load_s, meta = _promote_and_load(api, job_id, "K")
    served = _generate_against_engine(ctx, job_id, meta["vocab_size"], K_PROMPTS,
                                      CONTROL_NEW_TOKENS, seed, "k")
    return {
        "job_id": job_id, "second_job_id": second, "layers": K_LAYERS,
        "statuses": [st for st in ("queued", "running", "succeeded") if st in seen],
        "losses": [r["loss"] for r in records], "gpu_resource": resource,
        "submit_to_admitted_s": admitted - t_submit,
        "submit_to_running_s": seen["running"] - t_submit,
        "submit_to_first_ws_line_s": first_payload_ts - t_submit,
        "training_duration": job["training_duration"],
        "completed_to_succeeded_s": at["succeeded"] - times["completed"],
        "completed_to_deleted_s": deleted - times["completed"],
        "server_monitor_ticks": rt.monitor.ticks, "daemon_ticks": daemon_ticks,
        "queue_snapshot": snapshot, "waiting_lines": len(waiting),
        "ws_payload_lines": len(payload),
        "ws_close_after_trainer_exit_s": follow.close[2] - times["trainer_exit"],
        "ms_per_step": step_ms, "ms_per_step_median": steady[len(steady) // 2],
        "median_over_steps": [r["step"] for r in records if r["step"] > 1],
        "trainer_exit_to_completed_s": times["completed"] - times["trainer_exit"],
        "sidecar_end": "SIGTERMed after the trainer exited" if sigterm
        else "exited on done.txt before the trainer's exit was seen",
        "sidecar_sigterm_to_exit_s": (times["artifact-sync_exit"] - sigterm) if sigterm
        else None,
        "pod_artifact_files": len(local), "pod_artifact_bytes": tree_bytes(artifacts),
        "pod_files_not_synced": sorted(set(_sha_tree(artifacts)) - matched),
        "flash_launches": {n: launches.get(n, 0) for n in FLASH_KERNELS},
        "promote_s": promote_s, "model_load_s": load_s,
        **{k: served[k] for k in ("ttft_s", "decode_tokens_per_s", "requests_ok", "requests",
                                  "generated_tokens", "paged_launches")},
    }


REMAT_PHASE_POLICIES = ("none", "full", "mlp", "attn", "mlp_qkv", "flash", "mlp_flash", "wide",
                        "matmuls")
#: T5: flash forward launches per layer and microbatch of a training step:
#: the port runs the FlashAttention Function outside every checkpointed
#: segment under none, flash and mlp_flash, inside one under the others.
#: (The JAX package's gradient holds 2 under every policy but none: its
#: recompute rebuilds the attention output, which flash and mlp_flash do not
#: keep; tests/test_torch_remat.py counts both on the CPU.)
REMAT_FLASH_FORWARDS = {p: 1 if p in ("none", "flash", "mlp_flash") else 2
                        for p in REMAT_PHASE_POLICIES}


def remat_phase(seg, seed: int) -> dict:
    """T5: one forward and backward of llama3-8b cut to 2 layers (full width,
    bf16 base, LoRA rank 16 with non-zero B, B=2, S=2048, T3's packed
    segment ids, the flash kernels) under each remat policy: the loss within
    ``MODEL_LOSS_REL_TOL`` and every LoRA gradient within
    ``MODEL_GRAD_REL_TOL`` of its leaf's largest against ``none``'s, and the
    flash forward launches of the step equal to layers x microbatches (1) x
    ``REMAT_FLASH_FORWARDS``.  Printed per policy: ms per step (CUDA events,
    the median of 3 after one warm step), the peak of
    ``max_memory_allocated`` and the bytes the forward leaves allocated for
    the backward."""
    import torch
    from finetune_controller_tpu_torch.models.llama import PRESETS
    from finetune_controller_tpu_torch.models.lora import LoRAConfig
    from finetune_controller_tpu_torch.ops.kernels import flash_attention as fa
    from finetune_controller_tpu_torch.train.losses import next_token_loss
    from finetune_controller_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = PRESETS["llama3-8b"].replace(n_layers=2, lora=LoRAConfig(rank=16, alpha=32.0))
    trainer = Trainer(cfg, TrainConfig(frozen_dtype="bfloat16", batch_size=2, seq_len=2048,
                                       seed=seed), device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    with torch.no_grad():
        for name, p in trainer.trainable.items():
            if name.endswith(".lora_b"):
                p.normal_(0.0, 0.02, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, seg.shape, generator=gen, device=DEVICE)
    model = trainer.model
    out = {}

    def step():
        logits = model(tokens, segment_ids=seg)
        loss, _ = next_token_loss(logits, tokens)
        del logits
        kept = torch.cuda.memory_allocated()
        loss.backward()
        return loss, kept

    try:
        for policy in REMAT_PHASE_POLICIES:
            model.cfg = cfg.replace(remat_policy=policy)
            for p in trainer.trainable.values():
                p.grad = None
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            for name in FLASH_KERNELS:
                getattr(fa, name).launches = 0
            loss, kept = step()
            launches = {name: getattr(fa, name).launches for name in FLASH_KERNELS}
            grads = {n: p.grad.float().clone() for n, p in trainer.trainable.items()}
            peak = torch.cuda.max_memory_allocated() - base
            times = []
            for _ in range(3):
                for p in trainer.trainable.values():
                    p.grad = None
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
                step()
                t1.record()
                torch.cuda.synchronize()
                times.append(t0.elapsed_time(t1))
            out[policy] = {"loss": loss.item(), "grads": grads, "launches": launches,
                           "ms": sorted(times)[1], "peak_bytes": peak,
                           "kept_bytes": kept - base}
    finally:
        model.cfg = cfg
    l0, g0 = out["none"]["loss"], out["none"]["grads"]
    record = {}
    for policy, r in out.items():
        loss_rel = abs(r["loss"] - l0) / abs(l0)
        grad_rel = max(((r["grads"][n] - g0[n]).abs().max() / g0[n].abs().max()).item()
                       for n in g0)
        want = cfg.n_layers * REMAT_FLASH_FORWARDS[policy]
        record[policy] = {"loss": r["loss"], "loss_rel": loss_rel, "grad_rel": grad_rel,
                          "flash_launches": r["launches"], "flash_forwards_expected": want,
                          "ms_per_step": r["ms"], "peak_gb": r["peak_bytes"] / 1e9,
                          "kept_for_backward_gb": r["kept_bytes"] / 1e9}
        log(f"T5 remat {policy:>9}: loss rel {loss_rel:.3g}, worst LoRA grad rel "
            f"{grad_rel:.3g}; flash launches {r['launches']} (forward expected {want}); "
            f"{r['ms']:.1f} ms/step, peak {r['peak_bytes'] / 1e9:.3f} GB above the weights, "
            f"{r['kept_bytes'] / 1e9:.3f} GB kept for the backward")
        if not (math.isfinite(r["loss"]) and loss_rel <= MODEL_LOSS_REL_TOL
                and grad_rel <= MODEL_GRAD_REL_TOL):
            raise SmokeFailure(f"T5: {policy}: loss rel {loss_rel:.3g}, grad rel {grad_rel:.3g} "
                               f"against none (tolerances {MODEL_LOSS_REL_TOL}, "
                               f"{MODEL_GRAD_REL_TOL})")
        if DEVICE == "cuda" and r["launches"]["flash_forward"] != want:
            raise SmokeFailure(f"T5: {policy}: {r['launches']['flash_forward']} flash forward "
                               f"launches, want {want}")
    del trainer, model, out
    torch.cuda.empty_cache()
    return record


def packed_segments(work, seed: int):
    """Segment ids (2, 2048) int32 of the microbatch of T2's 8 steps (the
    loader seeded as the run's) that holds the most documents, so the
    kernels see document boundaries."""
    import torch
    from finetune_controller_tpu_torch.data.loader import jsonl_token_batches

    tcfg = TRAIN_SPEC["training"]
    batches = jsonl_token_batches(str(work / "train.jsonl"), batch_size=tcfg["batch_size"],
                                  seq_len=tcfg["seq_len"], seed=seed)
    rows = tcfg["batch_size"] // tcfg["grad_accum_steps"]
    micro = [batch["segment_ids"][i:i + rows] for batch in (next(batches) for _ in range(8))
             for i in range(0, tcfg["batch_size"], rows)]
    best = max(micro, key=lambda seg: sum(len(np.unique(row)) for row in seg))
    return torch.from_numpy(best).to("cuda", torch.int32)


def model_check(seg, seed: int) -> dict:
    """T3: loss and LoRA gradients of one step of llama3-8b cut to 2 layers
    (full width, bf16 base, B=2, S=2048, packed segments) with
    ``FTC_FLASH_ATTN=kernel`` against ``plain``."""
    import torch
    from finetune_controller_tpu_torch.models.llama import PRESETS
    from finetune_controller_tpu_torch.models.lora import LoRAConfig
    from finetune_controller_tpu_torch.train.losses import next_token_loss
    from finetune_controller_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = PRESETS["llama3-8b"].replace(n_layers=2, lora=LoRAConfig(rank=16, alpha=32.0))
    trainer = Trainer(cfg, TrainConfig(frozen_dtype="bfloat16", batch_size=2, seq_len=2048,
                                       seed=seed))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():  # non-zero B, so the A leaves get gradients too
        for name, p in trainer.trainable.items():
            if name.endswith(".lora_b"):
                p.normal_(0.0, 0.02, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, seg.shape, generator=gen, device="cuda")
    from torch.profiler import ProfilerActivity, profile

    out = {}
    try:
        for impl in ("kernel", "plain"):
            os.environ["FTC_FLASH_ATTN"] = impl
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                logits = trainer.model(tokens, segment_ids=seg)
                loss, _ = next_token_loss(logits, tokens)
                del logits
                loss.backward()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            out[impl] = (loss.item(), {n: p.grad.float() for n, p in trainer.trainable.items()})
            for p in trainer.trainable.values():
                p.grad = None
            if impl == "kernel":
                profiled = device_time_by_kernel(prof, wall)
    finally:
        os.environ.pop("FTC_FLASH_ATTN", None)
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    loss_rel = abs(lk - lp) / abs(lp)
    grad_rel = max(((gk[n] - gp[n]).abs().max() / gp[n].abs().max()).item() for n in gp)
    if not (math.isfinite(lk) and loss_rel <= MODEL_LOSS_REL_TOL and grad_rel <= MODEL_GRAD_REL_TOL):
        raise SmokeFailure(f"model check: loss {lk} vs {lp} (rel {loss_rel:.3g}), worst LoRA "
                           f"grad rel {grad_rel:.3g} (tolerances {MODEL_LOSS_REL_TOL}, "
                           f"{MODEL_GRAD_REL_TOL})")
    return {"loss_kernel": lk, "loss_plain": lp, "loss_rel": loss_rel, "grad_rel": grad_rel,
            "profile": profiled}


#: the port's ``record_function`` ranges: on the device timeline they span
#: kernels that are counted on their own
#: G: the flash kernels at Gemma's head dim 256, (B, S, H, Hkv, D): Gemma-7B's
#: heads (multi-head) and Gemma-2B's (one KV head); the first is timed
G_FLASH_SHAPES = {"gemma-7b": (2, 2048, 16, 16, 256), "gemma-2b": (2, 2048, 8, 1, 256)}
#: G's job: the shipped Gemma-7B example by its ``model_name`` at the
#: example's batch and sequence length (8 x 512), 5 steps
G_MODEL = "gemma-7b-lora"
G_FLAVOR = "h100"
G_ARGS = {"total_steps": 5, "checkpoint_every": 5, "log_every": 1}
#: G's depth, set by an operator plugin (``GEMMA_CUT_PLUGIN``): the whole run
#: must end inside 1200 s
G_LAYERS = 8
#: flash launches a step of G's job: ``mlp`` remat runs the forward twice
#: (``REMAT_FLASH_FORWARDS``), one microbatch a step
G_FLASH_PER_STEP = {"flash_forward": 2 * G_LAYERS, "flash_backward_dq": G_LAYERS,
                    "flash_backward_dkv": G_LAYERS}
#: the greedy ``/generate`` request after promotion (prompt tokens, new tokens)
G_PROMPTS = (64,)
G_NEW_TOKENS = 8
GEMMA_CUT_PLUGIN = '''"""``gemma-7b-lora`` at {layers} of its 28 layers."""

from finetune_controller_tpu_torch.controller.examples import Gemma7B_LoRA


class Gemma7B_LoRA_Cut(Gemma7B_LoRA):
    def build_trainer_spec(self, job_id, artifacts_dir, **kw):
        spec = super().build_trainer_spec(job_id, artifacts_dir, **kw)
        spec["model"].setdefault("overrides", {{}})["n_layers"] = {layers}
        return spec
'''


def gemma_flash_check(seed: int) -> dict:
    """G1: the three flash kernels against their plain versions at D = 256,
    Gemma-7B's and Gemma-2B's heads, bf16 and f32, causal with and without
    segment ids (``flash_compare``, ``TOLERANCE``).  Returns the worst error
    of each kernel by dtype and every case's errors."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed + 256)
    worst = {dt: dict.fromkeys(FLASH_KERNELS, 0.0) for dt in ("bfloat16", "float32")}
    cases = []
    for model, (b, s, h, hkv, d) in G_FLASH_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            for segments in (True, False):
                q, k, v, dout, dlse, seg = flash_inputs(gen, b, s, h, hkv, d, dtype, segments)
                errs = flash_compare(q, k, v, dout, dlse, seg, None, True)
                name = str(dtype).split(".")[1]
                for kernel, e in errs.items():
                    worst[name][kernel] = max(worst[name][kernel], e)
                cases.append({"model": model, "dtype": name, "segments": segments,
                              "max_abs_err": errs})
                del q, k, v, dout, dlse, seg
                torch.cuda.empty_cache()
    return {"worst": worst, "cases": cases}


def gemma_phase(work, seed: int, reps: int) -> dict:
    """G: Gemma's head dim 256 on the card.  G1 (:func:`gemma_flash_check`);
    G2 the kernels timed at Gemma-7B's heads beside the plain version, SDPA
    and the bound (:func:`flash_shape_bench`, bf16, causal, no segment ids,
    two launches bit-equal); G3 the shipped ``G_MODEL`` submitted by its
    ``model_name`` to the port's server (``G_FLAVOR``, full width, random
    base weights from the job's seed, ``G_LAYERS`` of 28 layers by an
    operator plugin, ``G_ARGS``, T2's documents): SUCCEEDED with finite
    losses, the trainer's ``kernel_launches`` events holding
    ``G_FLASH_PER_STEP`` launches a step of each flash kernel (the model's
    only head dim is 256), then promoted, loaded and one greedy
    ``/generate`` equal to an in-process engine through the paged kernel
    (its count zeroed just before and read just after).  Writes no HF base
    directory."""
    from finetune_controller_tpu_torch.models.llama import PRESETS

    t_phase = time.perf_counter()
    head_dim = PRESETS[G_MODEL.removesuffix("-lora")].head_dim
    checks = gemma_flash_check(seed) if DEVICE == "cuda" else {}
    t_checks = time.perf_counter() - t_phase
    bench = (flash_shape_bench(G_FLASH_SHAPES["gemma-7b"], reps, seed, "G2")
             if DEVICE == "cuda" else {})
    t_bench = time.perf_counter() - t_phase - t_checks
    ctrl = Path(__file__).resolve().parent / "build" / "chip_smoke_gemma"
    shutil.rmtree(ctrl, ignore_errors=True)
    (ctrl / "plugins").mkdir(parents=True)
    (ctrl / "plugins" / "gemma_depth.py").write_text(GEMMA_CUT_PLUGIN.format(layers=G_LAYERS))
    docs = Path(work) / "train.jsonl"
    if not docs.exists():
        write_documents(docs, seed)
    t_job = time.perf_counter()
    with control_plane(ctrl, CONTROL_ENV, plugin_dir=ctrl / "plugins") as ctx:
        api, scrape, rt, settings, on_loop, _ = ctx
        dataset = api.ok("POST", "/datasets", files={"file": ("train.jsonl", docs.read_bytes())},
                         want=(201,))
        t_submit = time.time()
        job_id = api.ok("POST", "/jobs", fields={
            "model_name": G_MODEL, "device": G_FLAVOR, "dataset_id": dataset["dataset_id"],
            "arguments": json.dumps(G_ARGS)})["job_id"]
        job, seen, logs = _follow_job(api, job_id, t_submit, "G")
        steps = G_ARGS["total_steps"]
        records = _job_rows(api, job_id, steps, "G")
        _, at = _timeline(api, job_id, ("submitted", "train-started", "succeeded"), "G")
        sandbox = settings.state_path / "sandboxes" / job_id / "artifacts"
        events = [json.loads(ln) for ln in (sandbox / "events.jsonl").read_text().splitlines()]
        launches = attempt_launches(events)
        want = {name: n * steps for name, n in G_FLASH_PER_STEP.items()}
        if DEVICE == "cuda" and (len(launches) != 1 or {
                name: launches[0].get(name, 0) for name in FLASH_KERNELS} != want):
            raise SmokeFailure(f"G: flash launches {launches} over {steps} steps, want {want}")
        promote_s, load_s, meta = _promote_and_load(api, job_id, "G")
        served = _generate_against_engine(ctx, job_id, meta["vocab_size"], G_PROMPTS,
                                          G_NEW_TOKENS, seed, "g")
        job_bytes = tree_bytes(settings.state_path / "sandboxes" / job_id)
    from finetune_controller_tpu_torch.controller.examples import LoRASFTArguments

    defaults = LoRASFTArguments()
    tokens = defaults.batch_size * defaults.seq_len
    step_ms = [tokens / r["tokens_per_sec"] * 1e3 for r in records]
    steady = sorted(step_ms[1:])
    record = {
        "job_id": job_id, "model": G_MODEL, "layers": G_LAYERS, "head_dim": head_dim,
        "batch_size": defaults.batch_size, "seq_len": defaults.seq_len,
        "statuses": [st for st in ("queued", "running", "succeeded") if st in seen],
        "losses": [r["loss"] for r in records], "ms_per_step": step_ms,
        "ms_per_step_median": steady[len(steady) // 2],
        "tokens_per_s_median": tokens / (steady[len(steady) // 2] / 1e3),
        "submit_to_first_step_s": records[0]["timestamp"] - at["submitted"],
        "flash_launches": launches[0] if launches else {},
        "promote_s": promote_s, "model_load_s": load_s,
        **{k: served[k] for k in ("ttft_s", "decode_tokens_per_s", "requests_ok", "requests",
                                  "generated_tokens", "paged_launches", "prompts", "answers")},
        "job_sandbox_bytes": job_bytes, "flash_check": checks, "flash_bench": bench,
        "checks_s": t_checks, "bench_s": t_bench, "job_s": time.perf_counter() - t_job,
        "phase_s": time.perf_counter() - t_phase,
    }
    shutil.rmtree(ctrl, ignore_errors=True)
    return record


def _report_gemma(g: dict) -> None:
    for dt, worst in g["flash_check"].get("worst", {}).items():
        log(f"G1 flash at D=256 (Gemma-7B H=Hkv=16, Gemma-2B H=8 Hkv=1; B=2, S=2048; causal "
            f"with and without segment ids) {dt} worst max abs err vs plain: "
            + ", ".join(f"{k} {v:.4g}" for k, v in worst.items()))
    for name, r in g["flash_bench"].items():
        log(f"G2 {name} at B=2, S=2048, H=Hkv=16, D=256, causal, no segment ids: kernel "
            f"{r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s, share of bound "
            f"{r['bound_share']:.3f}), plain {r['plain_ms']:.3f} ms, library (SDPA) "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"max abs err {r['max_abs_err']:.4g}")
    log(f"G3 {g['model']} ({g['layers']} of 28 layers, head dim {g['head_dim']}): "
        f"{' -> '.join(g['statuses'])}, {g['batch_size']} x {g['seq_len']} tokens, losses "
        f"{[round(x, 4) for x in g['losses']]}, steps {[round(x) for x in g['ms_per_step']]} ms, "
        f"{g['ms_per_step_median']:.0f} ms/step median of steps 2-5, "
        f"{g['tokens_per_s_median']:.0f} tokens/s; submit -> first step "
        f"{g['submit_to_first_step_s']:.1f} s; flash launches {g['flash_launches']}; promote "
        f"{g['promote_s']:.2f} s, load {g['model_load_s']:.1f} s; /generate "
        f"{g['requests_ok']}/{g['requests']} equal to the in-process engine, TTFT "
        f"{g['ttft_s'] * 1e3:.1f} ms, paged launches {g['paged_launches']}; checks "
        f"{g['checks_s']:.1f} s, bench {g['bench_s']:.1f} s, job {g['job_s']:.1f} s, phase "
        f"{g['phase_s']:.1f} s")


#: O: the JAX package's orbax checkpoint of a ``tiny-test`` job, committed
#: with its inputs and the JAX package's losses after resuming it
#: (``tests/fixtures/make_jax_orbax_tiny.py``)
O_FIXTURE = Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_orbax_tiny"
#: the resumed losses against the JAX package's: the CPU test's tolerance
#: (``test_the_committed_fixture_restores_to_the_jax_restore_and_resumes``)
O_LOSS_RTOL = 2e-5
#: decodes of the fixture's largest zstd frame timed for the decoder's rate
O_RATE_REPS = 20


def orbax_phase(work, seed: int) -> dict:
    """O: the fixture restored through the port (``train/ocdbt.py``, its
    zstd frames by the native decoder ``csrc/zstd_decode.cc``, built here
    with the host compiler) and its ``tiny-test`` job resumed on the card
    from step 2 through ``Trainer.fit``: the resumed losses within
    ``O_LOSS_RTOL`` of the JAX package's; then the native decoder timed over
    the fixture's largest frame (the 1 MB bf16 array's chunk), repeated,
    in MB/s of output."""
    import torch
    from finetune_controller_tpu_torch.models.llama import PRESETS
    from finetune_controller_tpu_torch.models.lora import LoRAConfig
    from finetune_controller_tpu_torch.train import ocdbt
    from finetune_controller_tpu_torch.train.checkpoint import CheckpointManager
    from finetune_controller_tpu_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    expected = json.loads((O_FIXTURE / "expected.json").read_text())
    out = Path(work) / "orbax_resume"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(O_FIXTURE / "checkpoints", out / "checkpoints")
    t0 = time.perf_counter()
    ckpt = CheckpointManager(out / "checkpoints", sweep=False)
    if ckpt.layout(expected["save_step"]) != "orbax":
        raise SmokeFailure(f"O: step {expected['save_step']} is not in orbax's layout")
    restored = ckpt.restore(expected["save_step"])
    restore_s = time.perf_counter() - t0
    cfg = PRESETS[expected["preset"]].replace(dtype=torch.float32,
                                              lora=LoRAConfig(rank=expected["lora_rank"]))
    trainer = Trainer(cfg, TrainConfig(**expected["train"]), device=DEVICE)
    base = np.load(O_FIXTURE / "base.npz")
    trainer.model.load_state_dict({k: torch.from_numpy(base[k]) for k in base.files})
    packed = np.load(O_FIXTURE / "batches.npz")
    batches = [{k.split("/", 1)[1]: packed[k] for k in packed.files if k.startswith(f"{i}/")}
               for i in range(expected["train"]["total_steps"])]
    t0 = time.perf_counter()
    trainer.fit(batches, str(out))
    resume_s = time.perf_counter() - t0
    rows = _rows(out / "metrics.csv")
    losses = [float(r["loss"]) for r in rows]
    if [int(r["step"]) for r in rows] != expected["resumed_steps"] or not np.allclose(
            losses, expected["losses"], rtol=O_LOSS_RTOL, atol=0):
        raise SmokeFailure(f"O: resumed rows {[(r['step'], r['loss']) for r in rows]}, the "
                           f"JAX package's {expected['losses']} (rtol {O_LOSS_RTOL})")
    store = ocdbt.open_step(O_FIXTURE / "large" / "step_0")
    frames = [(len(v), k, v) for k in store.keys() if not k.endswith(".zarray")
              for v in [store.get(k)]]
    size_c, key, frame = max(frames)
    raw_bytes = int(np.prod(expected["large_shape"])) * 2
    data = ocdbt.zstd_decompress(frame, raw_bytes)
    t0 = time.perf_counter()
    for _ in range(O_RATE_REPS):
        ocdbt.zstd_decompress(frame, raw_bytes)
    decode_s = (time.perf_counter() - t0) / O_RATE_REPS
    shutil.rmtree(out, ignore_errors=True)
    return {"restore_s": restore_s, "resume_s": resume_s, "losses": losses,
            "jax_losses": expected["losses"],
            "max_rel_diff": max(abs(a - b) / abs(b) for a, b in zip(losses, expected["losses"])),
            "restored_step": int(restored["step"]), "frame_key": key,
            "frame_bytes": size_c, "decoded_bytes": len(data),
            "decode_ms": decode_s * 1e3, "decode_mb_per_s": len(data) / decode_s / 1e6,
            "phase_s": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# A, J, N, B: serve as a scheduler tenant, the runtime guards, the native
# packer and the kernel bench
# ---------------------------------------------------------------------------

#: A: C's server settings plus the serve tenant: every replica of a served
#: job is a low-priority ``serve`` workload on the ``h100`` flavor (one chip
#: of quota), reconciled every 0.25 s; 2 queued requests per replica for 2
#: ticks grow the fleet (a scheduler submit)
A_ENV = {**CONTROL_ENV, "FTC_SERVE_AUTOSCALE": "true", "FTC_SERVE_FLAVOR": CONTROL_FLAVOR,
         "FTC_SERVE_MIN_REPLICAS": "1", "FTC_SERVE_MAX_REPLICAS": "2",
         "FTC_SERVE_SCALE_UP_QUEUE_DEPTH": "2", "FTC_SERVE_SCALE_SUSTAIN_TICKS": "2",
         "FTC_SERVE_HEALTH_INTERVAL_S": "0.25"}
#: A's training job: C's spec, 3 steps, no profiler window
A_ARGS = {**{k: v for k, v in CONTROL_ARGS.items() if k != "profile_steps"},
          "total_steps": 3, "checkpoint_every": 3}
#: the burst that pushes queue depth past the threshold (C's 4 prompts in turn)
A_BURST = 24
#: new tokens of the 4 requests in flight when the training job arrives:
#: their first ``CONTROL_NEW_TOKENS`` must equal C's answers
A_INFLIGHT_NEW_TOKENS = 48
#: the most the scheduler may take from the drain to the job's admission:
#: one monitor tick (``FTC_JOB_MONITOR_INTERVAL_S``) and the polling slack
A_ADMIT_AFTER_DRAIN_S = 1.5


def _card_mb() -> float | None:
    return CardMemorySampler.read()


def serve_tenant_phase(work, seed: int, control: dict, dataset_id: str) -> dict:
    """A: C's promoted job served by a server with ``serve_autoscale`` on, over
    the fair-share scheduler of the one-H100 catalog (a fresh control plane
    on C's state dir and object store).  The tenant attaches the replica as
    a ``serve`` workload; a burst of ``A_BURST`` requests grows the fleet by
    a second workload, which stays QUEUED on one chip of quota; then, with
    4 requests in flight, a normal-priority training job (``A_ARGS``) is
    submitted: the tenant takes the preemption and drains the replica (the
    4 finish, their tokens C's answers), the workload is released and the
    job admitted on the next scheduler tick; it trains on the flash kernels
    (its ``events.jsonl``).  While no replica is up ``/generate`` answers
    the router's 503.  After SUCCEEDED the tenant is admitted again at
    ``serve_min_replicas`` and ``/generate`` answers through the paged
    kernel.  Timed on the host clock (polling ``GET /admin/serve`` and the
    scheduler every 20 ms); the card's used memory read at each edge."""
    from concurrent.futures import ThreadPoolExecutor

    from finetune_controller_tpu_torch.ops.kernels import paged_attention as pa

    ctrl = Path(__file__).resolve().parent / "build" / "chip_smoke_ctrl"
    job_c, prompts, want = control["job_id"], control["prompts"], control["answers"]
    t_phase = time.perf_counter()
    with control_plane(ctrl, A_ENV, plugin_dir=ctrl / "plugins") as ctx:
        api, scrape, rt, settings, on_loop, _ = ctx
        sched = rt.backend.scheduler
        mem = {"before_load": _card_mb()}

        def session():
            return api.ok("GET", "/admin/serve")["sessions"].get(job_c) or {}

        # the burst's prompts are its own (C's lengths in turn): a prompt
        # seen before would hit the prefix cache, whose suffix prefill may
        # round differently from C's full one; the requests held to C's
        # answers are each prompt's first on the engine that serves it
        burst_prompts = []

        def generate(i, new_tokens, tag, prompt=None):
            status, out = api.call("POST", f"/jobs/{job_c}/generate", {
                "tokens": prompt or prompts[i % len(prompts)], "max_new_tokens": new_tokens,
                "request_id": f"{tag}{i}"})
            return status, out, None if prompt else want[f"c{i % len(prompts)}"]

        def lost(answers, new_tokens) -> list:
            return [(status, out) for status, out, ref in answers
                    if status != 200 or len(out["tokens"]) != new_tokens
                    or (ref is not None and out["tokens"][:len(ref)] != ref)]

        t0 = time.time()
        vocab = api.ok("POST", f"/admin/serve/{job_c}/load")["model"]["vocab_size"]
        load_s = time.time() - t0
        rng = np.random.default_rng(seed + 23)
        burst_prompts += [rng.integers(0, vocab, len(prompts[i % len(prompts)])).tolist()
                          for i in range(A_BURST)]
        (w0,) = session()["autoscale"]["workloads"]
        _wait_until(lambda: sched.is_admitted(w0), 30, "the serve workload admitted", "A")
        mem["serving"] = _card_mb()

        # the burst: queue depth past the threshold grows the fleet by a
        # second workload, which one chip of quota cannot admit
        pa.paged_attention.launches = 0
        polls = []
        with ThreadPoolExecutor(A_BURST) as pool:
            burst = [pool.submit(generate, i, CONTROL_NEW_TOKENS, "a", burst_prompts[i])
                     for i in range(A_BURST)]
            while not all(f.done() for f in burst):
                s = session()
                polls.append((s.get("queue_depth", 0), s.get("replicas_healthy", 0),
                              dict(s.get("autoscale", {}).get("workloads", {}))))
                time.sleep(0.05)
            burst = [f.result() for f in burst]
        burst_launches = pa.paged_attention.launches
        grow = sorted({wid for _, _, wls in polls for wid, rid in wls.items()
                       if wid != w0 and rid is None})
        tenant = session()["autoscale"]
        if lost(burst, CONTROL_NEW_TOKENS) or not grow or any(h > 1 for _, h, _ in polls) \
                or any(sched.is_admitted(w) for w in grow) or tenant["scale_ups_total"] < 1:
            raise SmokeFailure(
                f"A: burst lost {lost(burst, CONTROL_NEW_TOKENS)[:3]}, grow "
                f"workloads {grow} (admitted: {[sched.is_admitted(w) for w in grow]}), healthy "
                f"{sorted({h for _, h, _ in polls})}, tenant {tenant}")

        # a normal-priority training job while 4 requests are in flight
        mem["before_drain"] = _card_mb()
        pool = ThreadPoolExecutor(len(prompts))
        inflight = [pool.submit(generate, i, A_INFLIGHT_NEW_TOKENS, "f")
                    for i in range(len(prompts))]
        _wait_until(lambda: session().get("slots_busy", 0) >= len(prompts), 60,
                    "the 4 requests in flight", "A")
        t_submit = time.time()
        job_a = api.ok("POST", "/jobs", fields={
            "model_name": CONTROL_MODEL, "device": CONTROL_FLAVOR, "dataset_id": dataset_id,
            "arguments": json.dumps(A_ARGS)})["job_id"]
        edges = {}
        while time.time() - t_submit < 300 and "admitted" not in edges:
            s = session()
            now = time.time()
            if s.get("replicas_draining") and "drain_start" not in edges:
                edges["drain_start"] = now
            if not s.get("replicas_total") and "drained" not in edges:
                edges["drained"] = now
                mem["after_drain"] = _card_mb()
            if "drained" in edges and sched.is_admitted(job_a):
                edges["admitted"] = time.time()
            time.sleep(0.02)
        inflight = [f.result() for f in inflight]
        pool.shutdown()
        if "admitted" not in edges or lost(inflight, A_INFLIGHT_NEW_TOKENS):
            raise SmokeFailure(f"A: edges {sorted(edges)}, in flight lost "
                               f"{lost(inflight, A_INFLIGHT_NEW_TOKENS)}")
        unavailable = api.call("POST", f"/jobs/{job_c}/generate",
                               {"tokens": prompts[0], "max_new_tokens": 4})
        with CardMemorySampler() as sampler:
            job, seen, logs = _follow_job(api, job_a, t_submit, "A")
        records = _job_rows(api, job_a, A_ARGS["total_steps"], "A")
        _, at = _timeline(api, job_a, ("submitted", "running", "succeeded"), "A")
        t_end = time.time()
        _wait_until(lambda: session().get("replicas_healthy") == 1, 300,
                    "the replica back after the job", "A")
        edges["serving_again"] = time.time()
        mem["serving_again"] = _card_mb()
        pa.paged_attention.launches = 0
        with ThreadPoolExecutor(len(prompts)) as p:
            again = list(p.map(lambda i: generate(i, CONTROL_NEW_TOKENS, "g"),
                               range(len(prompts))))
        again_launches = pa.paged_attention.launches
        tenant = session()["autoscale"]
        events = [json.loads(ln) for ln in (settings.state_path / "sandboxes" / job_a
                                            / "artifacts" / "events.jsonl").read_text().splitlines()]
        launches = attempt_launches(events)
        api.ok("POST", f"/admin/serve/{job_c}/unload")
    n_lost = len(lost(burst, CONTROL_NEW_TOKENS)) + len(lost(inflight, A_INFLIGHT_NEW_TOKENS)) \
        + len(lost(again, CONTROL_NEW_TOKENS))
    if n_lost or len(launches) != 1 or any(launches[0].get(n, 0) <= 0 for n in FLASH_KERNELS) \
            or tenant["preempted_total"] != 1 or unavailable[0] != 503 \
            or (DEVICE == "cuda" and min(burst_launches, again_launches) <= 0):
        raise SmokeFailure(
            f"A: {n_lost} requests lost, the job's flash launches {launches}, tenant {tenant}, "
            f"/generate with no replica {unavailable}, paged launches {burst_launches} / "
            f"{again_launches}")
    record = {
        "job_id": job_a, "served_job": job_c, "load_s": load_s,
        "statuses": [st for st in ("queued", "running", "succeeded") if st in seen],
        "burst": A_BURST, "burst_queue_depth_max": max(d for d, _, _ in polls),
        "grow_workloads_queued": grow, "requests_lost": n_lost,
        "requests": len(burst) + len(inflight) + len(again),
        "submit_to_drain_start_s": edges.get("drain_start", edges["drained"]) - t_submit,
        "drain_s": edges["drained"] - edges.get("drain_start", edges["drained"]),
        "drain_to_admitted_s": edges["admitted"] - edges["drained"],
        "admitted_to_first_step_s": records[0]["timestamp"] - edges["admitted"],
        "succeeded_to_serving_s": edges["serving_again"] - at["succeeded"],
        "succeeded_seen_to_serving_s": edges["serving_again"] - t_end,
        "no_replica_answer": {"status": unavailable[0], "detail": unavailable[1]},
        "job_losses": [r["loss"] for r in records], "job_flash_launches": launches[0],
        "job_peak_card_gb_over_start": sampler.peak_gb, "card_used_mb": mem,
        "paged_launches_burst": burst_launches, "paged_launches_after": again_launches,
        "tenant": tenant, "phase_s": time.perf_counter() - t_phase,
    }
    if record["drain_to_admitted_s"] > A_ADMIT_AFTER_DRAIN_S:
        raise SmokeFailure(f"A: the job was admitted {record['drain_to_admitted_s']:.2f} s "
                           f"after the drain (a scheduler tick is "
                           f"{CONTROL_ENV['FTC_JOB_MONITOR_INTERVAL_S']} s)")
    log(f"A serve tenant: {job_c} loaded with serve_autoscale in {load_s:.1f} s; a burst of "
        f"{A_BURST} requests (queue depth up to {record['burst_queue_depth_max']}) submitted "
        f"{len(grow)} grow workload(s), each QUEUED on one chip of quota (the policy cancels a "
        f"pending grow when the pressure lapses); {job_a} (C's spec, 3 steps) submitted "
        f"with 4 requests in flight: drain began {record['submit_to_drain_start_s']:.2f} s "
        f"after the submit and took {record['drain_s']:.2f} s, the job admitted "
        f"{record['drain_to_admitted_s']:.2f} s after the drain, its first step "
        f"{record['admitted_to_first_step_s']:.1f} s after admission; /generate with no replica "
        f"answered {unavailable[0]} ({unavailable[1]}); SUCCEEDED -> serving again "
        f"{record['succeeded_to_serving_s']:.2f} s; {n_lost} of {record['requests']} requests "
        f"lost; the job's flash launches {launches[0]}; paged launches {burst_launches} "
        f"(burst), {again_launches} (after); card used MB {mem}; the job's peak over the "
        f"server {sampler.peak_gb} GB; tenant {tenant}")
    return record


#: J: new tokens of each request of S1's mix under the transfer guard
J_NEW_TOKENS = 16
#: J: the trainer's steps (the first is exempt from the guard)
J_STEPS = 5


def _timed_decode(engine, reqs) -> tuple[dict, list[float]]:
    """``BatchEngine.run``'s loop with each decode step on the host clock
    (a step ends in the host fetch of its (slots,) token vector)."""
    results, pending, step_s = {}, list(reqs), []
    while pending or engine.active_requests:
        while pending and engine.free_slots and engine.can_admit(pending[0]):
            done = engine.admit(pending.pop(0))
            if done is not None:
                results[done.request_id] = done
        t0 = time.perf_counter()
        for done in engine.step():
            results[done.request_id] = done
        step_s.append(time.perf_counter() - t0)
    return results, step_s


def guard_decode_phase(model, reqs) -> dict:
    """J, the engine: S1's request mix (``J_NEW_TOKENS`` each) through a
    fresh S1 engine with ``FTC_TRANSFER_GUARD`` unset and ``raise``, twice
    each in turns, driven on this (main) thread, so the decode window arms
    the CUDA sync-debug mode.  The guarded runs must trip 0 times with the
    same tokens, their distinct signatures within the engine's budget; the
    sync-free sampler must draw ``torch.multinomial``'s tokens on the card.
    Returns decode ms/step off and on, the counts and the paged launches."""
    import dataclasses

    import torch
    from finetune_controller_tpu_torch.models.generate import _sample
    from finetune_controller_tpu_torch.ops.kernels import paged_attention as pa
    from finetune_controller_tpu_torch.serve.engine import BatchEngine, EngineConfig, warm_engine

    for s in range(8):
        logits = torch.randn((4, 32000), generator=torch.Generator("cuda").manual_seed(s),
                             device="cuda")
        a = _sample(logits, temperature=0.8, top_k=50,
                    generator=torch.Generator("cuda").manual_seed(s))
        scaled = logits / 0.8
        kth = torch.sort(scaled, dim=-1).values[:, -50][:, None]
        probs = torch.softmax(scaled.masked_fill(scaled < kth, float("-inf")), dim=-1)
        b = torch.multinomial(probs, 1, generator=torch.Generator("cuda").manual_seed(s))[:, 0]
        if not torch.equal(a, b):
            raise SmokeFailure(f"J: the sync-free sampler drew {a.tolist()}, multinomial "
                               f"{b.tolist()}")
    ecfg = EngineConfig(slots=8, prompt_buckets=(32, 128, 512), max_new_tokens=128,
                        prefix_cache_bytes=512 << 20, page_tokens=16)
    jreqs = [dataclasses.replace(r, max_new_tokens=min(r.max_new_tokens, J_NEW_TOKENS))
             for r in reqs]
    ms = {"off": [], "raise": []}
    tokens, out, launches = {}, {}, 0
    saved = os.environ.pop("FTC_TRANSFER_GUARD", None)
    try:
        for mode in ("off", "raise", "off", "raise"):
            if mode == "raise":
                os.environ["FTC_TRANSFER_GUARD"] = "raise"
            else:
                os.environ.pop("FTC_TRANSFER_GUARD", None)
            engine = BatchEngine(model, ecfg)
            warm_engine(engine)
            torch.cuda.synchronize()
            pa.paged_attention.launches = 0
            results, step_s = _timed_decode(engine, jreqs)
            launches += pa.paged_attention.launches
            ms[mode].append(sum(step_s) / len(step_s) * 1e3)
            got = {rid: r.generated for rid, r in results.items()}
            if tokens.setdefault(mode, got) != got:
                raise SmokeFailure(f"J: two {mode} runs of one request mix gave different tokens")
            guard = engine._transfer_guard
            if (guard is None) != (mode == "off"):
                raise SmokeFailure(f"J: FTC_TRANSFER_GUARD={mode} built guard {guard}")
            if guard is not None:
                if guard.trips or torch.cuda.get_sync_debug_mode() != 0:
                    raise SmokeFailure(f"J: the decode guard tripped {guard.trips} times")
                out = {"trips": guard.trips, "windows": guard._calls.get("decode", 0),
                       "signatures": engine.guard.counts(), "budget": engine.guard.budget}
            del engine
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("FTC_TRANSFER_GUARD", None)
        if saved is not None:
            os.environ["FTC_TRANSFER_GUARD"] = saved
    if tokens["off"] != tokens["raise"]:
        raise SmokeFailure("J: the guarded engine's tokens differ from the unguarded one's")
    if sum(out["signatures"].values()) > out["budget"]:
        raise SmokeFailure(f"J: signatures {out['signatures']} past the budget {out['budget']}")
    return {**out, "decode_ms_per_step_off": ms["off"], "decode_ms_per_step_raise": ms["raise"],
            "requests": len(jreqs), "new_tokens": J_NEW_TOKENS, "paged_launches": launches}


def guard_train_phase(seg, seed: int) -> dict:
    """J, the trainer: ``J_STEPS`` steps of llama3-8b cut to 2 layers at T3's
    shape (full width, bf16 base, LoRA rank 16, B=2, S=2048, T3's packed
    segments) through ``Trainer.step`` with ``transfer_guard="raise"``,
    ``recompile_budget=2`` (``raise``) and no prefetch thread, so the step's
    window arms the CUDA sync-debug mode: 0 trips and one signature.  Then
    the same under ``FTC_FAULT_TRANSFER=1``: the guard's host copy inside
    the second step's window must abort it with the sync-debug mode's
    error (a real CUDA sync; the CPU cannot show it).  The flash kernels'
    counts are zeroed before the clean steps and read after."""
    import torch
    from finetune_controller_tpu_torch.analysis.transfer_guard import TransferGuardError
    from finetune_controller_tpu_torch.data.loader import batches_from_tokens
    from finetune_controller_tpu_torch.models.llama import PRESETS
    from finetune_controller_tpu_torch.models.lora import LoRAConfig
    from finetune_controller_tpu_torch.ops.kernels import flash_attention as fa
    from finetune_controller_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = PRESETS["llama3-8b"].replace(n_layers=2, lora=LoRAConfig(rank=16, alpha=32.0))
    tcfg = TrainConfig(frozen_dtype="bfloat16", batch_size=2, seq_len=2048, seed=seed,
                       prefetch=0, transfer_guard="raise", recompile_budget=2,
                       recompile_action="raise", total_steps=J_STEPS, warmup_steps=1)
    host_seg = seg.cpu().numpy()
    tokens = np.random.default_rng(seed + 17).integers(0, cfg.vocab_size, host_seg.shape)
    batches = batches_from_tokens(tokens.astype(np.int32), host_seg, 2, seed=seed)
    saved = os.environ.pop("FTC_FAULT_TRANSFER", None)
    try:
        trainer = Trainer(cfg, tcfg)
        for name in FLASH_KERNELS:
            getattr(fa, name).launches = 0
        step_ms, losses = [], []
        for _ in range(J_STEPS):
            batch = next(batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.step(batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
        launches = {name: getattr(fa, name).launches for name in FLASH_KERNELS}
        guard, counts = trainer._transfer_guard, trainer._recompile_guard.counts()
        if guard.trips or not guard.arm_cuda or min(launches.values()) <= 0 \
                or sum(counts.values()) != 1 or not all(map(math.isfinite, losses)):
            raise SmokeFailure(f"J: guarded steps tripped {guard.trips} times (CUDA mode "
                               f"{guard.arm_cuda}), signatures {counts}, losses {losses}, "
                               f"flash launches {launches}")
        clean = {"trips": guard.trips, "windows": guard._calls, "signatures": counts,
                 "losses": losses, "ms_per_step": step_ms, "flash_launches": launches}
        del trainer, guard
        gc.collect()
        torch.cuda.empty_cache()
        os.environ["FTC_FAULT_TRANSFER"] = "1"
        trainer = Trainer(cfg, tcfg)
        aborted_at, error = None, ""
        for i in range(J_STEPS):
            try:
                trainer.step(next(batches))
            except TransferGuardError as e:
                aborted_at, error = i + 1, str(e)
                break
        if aborted_at != 2 or "sync-debug mode caught" not in error \
                or torch.cuda.get_sync_debug_mode() != 0:
            raise SmokeFailure(f"J: the injected sync aborted step {aborted_at}: {error!r}")
        fault = {"aborted_at_step": aborted_at, "error": error[:300],
                 "trips": trainer._transfer_guard.trips}
        del trainer
    finally:
        os.environ.pop("FTC_FAULT_TRANSFER", None)
        if saved is not None:
            os.environ["FTC_FAULT_TRANSFER"] = saved
        gc.collect()
        torch.cuda.empty_cache()
    return {"clean": clean, "fault": fault}


#: N: the JSONL's size and the rows' pool (chat and SFT, text and tokens)
N_BYTES = 200 * 10**6
N_POOL = 4096


def write_packer_rows(path: Path, seed: int, nbytes: int = N_BYTES) -> dict:
    """N's dataset: ``N_POOL`` rows drawn from ``seed`` — chat (system, user and
    assistant turns, one in three with a second exchange), SFT
    prompt/completion text and SFT token rows, with escapes and non-ASCII
    text — written in a seeded order until ``nbytes``."""
    rng = np.random.default_rng(seed)
    words = ["".join(chr(c) for c in rng.integers(97, 123, rng.integers(2, 10)))
             for _ in range(4000)] + ["café", "naïve", "♞", "😀", '"q"', "a\\b", "t\tx", "l\nb"]

    def text(n):
        return " ".join(words[i] for i in rng.integers(0, len(words), n))

    pool = []
    for i in range(N_POOL):
        kind = i % 4
        if kind == 0:
            row = {"messages": [{"role": "system", "content": text(8)},
                                {"role": "user", "content": text(40)},
                                {"role": "assistant", "content": text(80)}]}
        elif kind == 1:
            row = {"prompt": text(40), "completion": text(60)}
        elif kind == 2:
            row = {"prompt_tokens": rng.integers(0, 128000, 50).tolist(),
                   "completion_tokens": rng.integers(0, 128000, 30).tolist()}
        else:
            row = {"messages": [{"role": "user", "content": text(30)},
                                {"role": "assistant", "content": text(50)},
                                {"role": "user", "content": text(10)},
                                {"role": "assistant", "content": text(30)}]}
        pool.append((json.dumps(row, ensure_ascii=bool(i % 2)) + "\n").encode())
    rows = size = 0
    with open(path, "wb") as f:
        while size < nbytes:
            for j in rng.integers(0, N_POOL, 4096):
                f.write(pool[j])
                size += len(pool[j])
                rows += 1
    return {"bytes": size, "rows": rows}


def _digests(arrays) -> list:
    import hashlib

    return [[list(a.shape), str(a.dtype), hashlib.sha256(np.ascontiguousarray(a)).hexdigest()]
            for a in arrays]


N_PYTHON_PACK = """
import json, sys, time, hashlib
import numpy as np
from finetune_controller_tpu_torch.data.loader import load_token_documents, pack_documents
t0 = time.perf_counter()
arrays = pack_documents(load_token_documents(sys.argv[1]), int(sys.argv[2]))
s = time.perf_counter() - t0
print(json.dumps({"seconds": s, "digests": [[list(a.shape), str(a.dtype),
      hashlib.sha256(np.ascontiguousarray(a)).hexdigest()] for a in arrays]}))
"""


def native_packer_phase(work, seed: int) -> dict:
    """N: ``write_packer_rows`` (counted by ``DiskTally``), packed into
    2048-token blocks by the native packer (``csrc/packer.cc``, built here
    by the host compiler) on this thread; then the Python loader packs the
    same file in a subprocess of its own, which runs beside the phases
    that follow (one of the host's cores) and is joined by
    :func:`native_packer_finish`: the arrays' SHA-256 digests must be
    equal."""
    from finetune_controller_tpu_torch.data import native_loader

    path = Path(work) / "packer_rows.jsonl"
    t0 = time.perf_counter()
    written = write_packer_rows(path, seed)
    write_s = time.perf_counter() - t0
    native_loader._library()  # the first use builds the library (host compiler)
    t0 = time.perf_counter()
    arrays = native_loader.pack_jsonl_native(str(path), 2048)
    native_s = time.perf_counter() - t0
    digests = _digests(arrays)
    blocks = arrays[0].shape[0]
    del arrays
    gc.collect()
    proc = subprocess.Popen(
        [sys.executable, "-c", N_PYTHON_PACK, str(path), "2048"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=str(Path(__file__).resolve().parent))
    # a run that fails before the join leaves no packer behind
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"path": str(path), **written, "write_s": write_s, "native_s": native_s,
            "native_mb_per_s": written["bytes"] / native_s / 1e6, "blocks": blocks,
            "digests": digests, "proc": proc}


def native_packer_finish(n: dict) -> dict:
    """N, joined: the Python path's digests against the native ones."""
    proc = n.pop("proc")
    out, err = proc.communicate(timeout=900)
    Path(n["path"]).unlink(missing_ok=True)
    if proc.returncode != 0:
        raise SmokeFailure(f"N: the Python packer exited {proc.returncode}: {err[-2000:]}")
    py = json.loads(out.strip().splitlines()[-1])
    if py["digests"] != n["digests"]:
        raise SmokeFailure(f"N: native {n['digests']} against Python {py['digests']}")
    n.update(python_s=py["seconds"], python_mb_per_s=n["bytes"] / py["seconds"] / 1e6,
             bit_equal=True)
    return n


#: B: the kernel bench at T2's flash shape and the paged decode shape (S1's
#: lane holds 40 pages of 16 tokens)
B_FLASH_SHAPE = dict(batch=2, seq=2048, heads=32, kv_heads=8, head_dim=128)
B_PAGED_SHAPE = dict(batch=8, heads=32, kv_heads=8, head_dim=128, page_tokens=16,
                     pages_per_lane=(40, 256))


def kernel_bench_phase(flash: dict, paged_entry: dict) -> dict:
    """B: ``ops/kernel_bench.py`` on the card (chained calls, host clock):
    ``bench_attention`` and ``bench_flash_variants`` (1 and 4 documents a
    row) at T2's flash shape, ``bench_paged_variants`` at the decode shape;
    beside T4's CUDA-event times and S1's CUDA-graph replay of the paged
    kernel, with SDPA as a yardstick.  The gate keeps the kernel on the card
    at every length."""
    import torch
    from finetune_controller_tpu_torch.ops import kernel_bench

    for seq in (1, 512, 1023, 1024, 8192):
        if kernel_bench.preferred_impl(seq, "cuda") != "kernel":
            raise SmokeFailure(f"B: the auto gate routes S={seq} off the kernel")
    t0 = time.perf_counter()
    attn = kernel_bench.bench_attention(**B_FLASH_SHAPE, dtype=torch.bfloat16, iters=10)
    variants = kernel_bench.bench_flash_variants(**B_FLASH_SHAPE, dtype=torch.bfloat16,
                                                 iters=8, documents=(1, 4))
    paged = kernel_bench.bench_paged_variants(**B_PAGED_SHAPE, dtype=torch.bfloat16, iters=20)
    events_grad = sum(flash[n]["ms"] for n in FLASH_KERNELS)
    out = {"attention_ms": {k: v * 1e3 for k, v in attn.items()},
           "flash_variants_ms": {k: v * 1e3 for k, v in variants.items()},
           "paged_variants_ms": {k: v * 1e3 for k, v in paged.items()},
           "t4_events_ms": {n: flash[n]["ms"] for n in FLASH_KERNELS},
           "t4_events_grad_ms": events_grad,
           "s1_paged_decode_graph_ms": paged_entry["ms"],
           "phase_s": time.perf_counter() - t0}
    log(f"B kernel_bench at B=2, S=2048, H=32, Hkv=8, D=128 (chained, host clock): forward "
        f"kernel {attn['kernel_fwd_s'] * 1e3:.4f} ms (T4 CUDA events {flash['flash_forward']['ms']:.4f}"
        f" ms), plain {attn['plain_fwd_s'] * 1e3:.3f} ms, SDPA {attn['sdpa_fwd_s'] * 1e3:.4f} ms; "
        f"grad kernel {attn['kernel_grad_s'] * 1e3:.4f} ms (T4 forward + dQ + dK/dV "
        f"{events_grad:.4f} ms), plain {attn['plain_grad_s'] * 1e3:.3f} ms, SDPA "
        f"{attn['sdpa_grad_s'] * 1e3:.4f} ms; variants (grad) "
        + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in variants.items()))
    log(f"B paged decode at B=8, H=32, Hkv=8, D=128, 16-token pages (chained): "
        + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in paged.items())
        + f"; S1's CUDA-graph replay of the kernel at 40 pages {paged_entry['ms']:.4f} ms")
    return out


PROFILER_RANGES = ("int4_dequantize", "moe_route", "moe_dispatch", "vision_tower",
                   "mm_projector", "evaluate", "dpo_reference_forward")


def device_time_by_kernel(prof, wall_s: float, top: int = 10) -> dict:
    """Wall ms, device ms, device-busy share, the ``top`` kernels (ms) and
    every flash-attention kernel (ms) of a ``torch.profiler`` window."""
    from torch.autograd import DeviceType

    by_name: dict[str, float] = {}
    for evt in prof.key_averages():
        # device-side events only: an operator's row repeats its kernels' time
        if evt.device_type != DeviceType.CUDA or evt.key in PROFILER_RANGES \
                or getattr(evt, "is_user_annotation", False):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us
    device_ms = sum(by_name.values()) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_s * 1e3, "device_ms": device_ms or None,
            "device_busy": device_ms / (wall_s * 1e3) if device_ms else None,
            "top": [(name[:60], us / 1e3) for name, us in ranked],
            "flash": [(name[:60], us / 1e3) for name, us in by_name.items() if "flash_" in name]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the serving model's depth (0 = the preset's)")
    ap.add_argument("--reps", type=int, default=64, help="timed launches per shape")
    ap.add_argument("--phase-child", nargs=3, metavar=("PHASE", "WORK", "OUT"),
                    help=argparse.SUPPRESS)  # a phase's own process (phase_start)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    try:
        from finetune_controller_tpu_torch.ops.kernels import build
        from finetune_controller_tpu_torch.ops.kernels import flash_attention as fa
    except ImportError as e:
        return fail(f"the port's package is not importable beside this script: {e}")
    share_bytecode()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.phase_child:
        name, work, out = args.phase_child
        try:
            record = CHILD_PHASES[name](Path(work), args.seed)
        except SmokeFailure as e:
            return fail(str(e))
        except (AssertionError, RuntimeError, ValueError) as e:
            return fail(f"{name}: {type(e).__name__}: {e}")
        Path(out).write_text(json.dumps(record))
        return 0
    start_watchdog()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        return fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 2. build every kernel source; check each kernel at small shapes (T1)
    t0 = time.perf_counter()
    try:
        built = build.build()
    except RuntimeError as e:
        return fail(f"kernel build: {e}")
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name in built:
        for fn, line in build.ptxas_report(name).items():
            log(f"  ptxas {name}: {kernel_label(fn)}: {line}")
    try:
        small_err = kernel_check_small()
        flash_small = flash_check_small()
    except (AssertionError, RuntimeError, ValueError) as e:
        return fail(f"small-shape kernel check: {e}")
    log(f"small-shape kernel checks ok (bf16 max abs err: paged {small_err:.4g}, "
        + ", ".join(f"{k} {v:.4g}" for k, v in flash_small.items()) + ")")
    try:
        DISK.mark("the build and T1")
        int4 = int4_check(args.seed)
        # 3-7. serving
        paged_entry, serve_summary = serve_phase(args)
        DISK.mark("S1")
    except SmokeFailure as e:
        return fail(str(e))
    except (AssertionError, RuntimeError, ValueError) as e:
        return fail(f"Q0/S1: {type(e).__name__}: {e}")
    gc.collect()
    torch.cuda.empty_cache()

    # T2, S2, T3, T4: training, serving what it trained, the flash kernels
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        fproof = phase_start("F", work, args.seed)
        hf_base = hf_base_phase(work, args.seed)
        DISK.mark("H1")
        from finetune_controller_tpu_torch.data import native_loader

        packs_before = native_loader.packs_total
        train = train_phase(work, args.seed)
        train["native_packs"] = native_loader.packs_total - packs_before
        if train["native_packs"] <= 0:
            raise SmokeFailure("T2: the loader did not take the native JSONL packer")
        DISK.mark("T2")
        log(f"train: llama3-8b LoRA SFT from the HF directory, {train['steps']} steps "
            f"(6 + 2 resumed), eval every 3 steps, "
            f"{train['ms_per_step_median']:.0f} ms/step median, "
            f"{train['tokens_per_s_median']:.0f} tokens/s, peak memory "
            f"{train['peak_memory_gb']:.2f} GB, flash launches {train['launches']}")
        gc.collect()
        torch.cuda.empty_cache()
        merged = merged_roundtrip_phase(work / "artifacts", train["export_s"])
        DISK.mark("H2")
        s2_launches, serve_tenants = serve_tenants_phase(work / "artifacts", args.seed)
        if s2_launches <= 0:
            raise SmokeFailure("S2: the paged-attention kernel was not launched on its path")
        paged_entry["launches"] += s2_launches
        paged_entry["launches_by_path"]["s2"] = s2_launches
        DISK.mark("S2")
        gc.collect()
        torch.cuda.empty_cache()
        control, qlora, llava, dpo, tenant = control_phase(work, args.seed)
        for path, record in (("c_generate", control), ("q_generate", qlora),
                             ("p_generate", dpo)):
            paged_entry["launches"] += record["paged_launches"]
            paged_entry["launches_by_path"][path] = record["paged_launches"]
        a_paged = tenant["paged_launches_burst"] + tenant["paged_launches_after"]
        paged_entry["launches"] += a_paged
        paged_entry["launches_by_path"]["a_generate"] = a_paged
        DISK.mark("A")
        gc.collect()
        torch.cuda.empty_cache()
        for name in FLASH_KERNELS:
            getattr(fa, name).launches = 0
        resilience = resilience_phase(work, args.seed, control)
        # R's job counts its launches in its own trainer processes; this
        # process's counts are R2's in-process trainer
        r2_launches = {name: getattr(fa, name).launches for name in FLASH_KERNELS}
        if min(r2_launches.values()) <= 0:
            raise SmokeFailure(f"R2: flash launches {r2_launches}")
        DISK.mark("R")
        gc.collect()
        torch.cuda.empty_cache()
        # W: C's job served from worker processes, and started warm; each
        # worker counts its own paged launches from its warm-up on, the
        # warm trainer its flash launches in the job's events
        workers = worker_phase(work, args.seed, control, dpo)
        w1_paged = sum(workers["paged_launches"].values())
        paged_entry["launches"] += w1_paged
        paged_entry["launches_by_path"]["w1_workers"] = w1_paged
        DISK.mark("W")
        gc.collect()
        torch.cuda.empty_cache()
        # D: C's job with its state in statestore_main and its objects on
        # S3, its log followed over a WebSocket; /generate in this process
        # K: the k8s backend on D's S3 and state service; its pod's trainer
        # counts its flash launches in its events, /generate runs here
        # M (its own process, its flash launches counted there) beside D and K
        mchild = phase_start("M", work, args.seed)
        storage, k8s = storage_phase(work, args.seed, card)
        for path, record in (("d_generate", storage), ("k_generate", k8s)):
            paged_entry["launches"] += record["paged_launches"]
            paged_entry["launches_by_path"][path] = record["paged_launches"]
        DISK.mark("K")
        moe = phase_finish(mchild)
        DISK.mark("M (joined)")
        gc.collect()
        torch.cuda.empty_cache()
        # N: the native packer now; the Python loader packs the same file in
        # a subprocess beside the next phases, joined at the end
        packer = native_packer_phase(work, args.seed)
        DISK.mark("N")
        # G: Gemma's head dim 256, the kernels alone and the shipped job;
        # the job's trainer counts its flash launches in its events
        gemma = gemma_phase(work, args.seed, max(4, args.reps // 8))
        _report_gemma(gemma)
        paged_entry["launches"] += gemma["paged_launches"]
        paged_entry["launches_by_path"]["g_generate"] = gemma["paged_launches"]
        DISK.mark("G")
        gc.collect()
        torch.cuda.empty_cache()
        # O: the JAX package's orbax checkpoint resumed on the card
        orbax = orbax_phase(work, args.seed)
        log(f"O orbax fixture: restored in {orbax['restore_s']:.3f} s, resumed steps "
            f"{orbax['losses']} against the JAX package's {orbax['jax_losses']} (max rel "
            f"{orbax['max_rel_diff']:.3g}, rtol {O_LOSS_RTOL}) in {orbax['resume_s']:.1f} s; "
            f"native zstd decoder over {orbax['frame_key']} ({orbax['frame_bytes']} -> "
            f"{orbax['decoded_bytes']} bytes): {orbax['decode_ms']:.2f} ms, "
            f"{orbax['decode_mb_per_s']:.1f} MB/s of output ({O_RATE_REPS} repeats, host CPU)")
        DISK.mark("O")
        gc.collect()
        torch.cuda.empty_cache()
        prefs, prefs_eval = preference_rows(work, args.seed)
        dpo_check = dpo_objective_check(prefs, args.seed)
        log(f"P0 DPO objective (2 full-width layers, 8 pairs x 512, {dpo_check['padded_rows']} "
            f"of 16 rows right-padded, kernel vs plain): sequence logprobs rel "
            f"{dpo_check['seq_logprob_rel']:.3g} (max abs {dpo_check['seq_logprob_abs_err']:.4g} "
            f"nats; against the plain path in f32: kernel "
            f"{dpo_check['seq_logprob_abs_err_kernel_vs_f32']:.4g}, plain bf16 "
            f"{dpo_check['seq_logprob_abs_err_plain_vs_f32']:.4g}), worst LoRA grad rel "
            f"{dpo_check['grad_rel']:.3g}; loss {dpo_check['loss_kernel']:.6f} vs "
            f"{dpo_check['loss_plain']:.6f} (rel {dpo_check['loss_rel']:.3g}; f32 "
            f"{dpo_check['loss_plain_f32']:.6f}: kernel rel {dpo_check['loss_rel_kernel_vs_f32']:.3g}, "
            f"plain bf16 rel {dpo_check['loss_rel_plain_vs_f32']:.3g}), reward_margin "
            f"{dpo_check['margin_kernel']:.5g} vs {dpo_check['margin_plain']:.5g} (f32 "
            f"{dpo_check['margin_plain_f32']:.5g}); kernel launches "
            f"{dpo_check['kernel_launches']}, lse finite on all "
            f"{dpo_check['lse_finite_forwards']} forward launches")
        gc.collect()
        torch.cuda.empty_cache()
        flash_dpo = flash_shape_bench(DPO_FLASH_SHAPE, max(4, args.reps // 8), args.seed, "P0")
        for name, r in flash_dpo.items():
            log(f"P0 {name} at B=16, S=512, H=32, Hkv=8, D=128, causal, no segment ids: "
                f"kernel {r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s, share of bound "
                f"{r['bound_share']:.3f}), plain {r['plain_ms']:.3f} ms, library (SDPA) "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"max abs err {r['max_abs_err']:.4g}")
        gc.collect()
        torch.cuda.empty_cache()
        reward = reward_phase(work, prefs, prefs_eval, args.seed)
        DISK.mark("P2")
        gc.collect()
        torch.cuda.empty_cache()
        rlhf = rlhf_phase(work, args.seed)
        paged_entry["launches"] += rlhf["paged_launches"]
        paged_entry["launches_by_path"]["p_rlhf_actor"] = rlhf["paged_launches"]
        DISK.mark("P3")
        gc.collect()
        torch.cuda.empty_cache()
        # P4: each rollout worker counts its paged launches, the reward
        # worker its flash forwards (their probes); the learner runs here
        remote = rollout_plane_phase(work, args.seed, rlhf)
        p4_paged = sum(remote["paged_launches"].values())
        paged_entry["launches"] += p4_paged
        paged_entry["launches_by_path"]["p4_rollout_workers"] = p4_paged
        DISK.mark("P4")
        gc.collect()
        torch.cuda.empty_cache()
        flash_llava = flash_shape_bench(LLAVA_FLASH_SHAPE, max(4, args.reps // 8), args.seed,
                                        "V0")
        for name, r in flash_llava.items():
            log(f"V0 {name} at B=2, S=2048 (576 image + 1472 text), H=Hkv=32, D=128, causal, "
                f"no segment ids: kernel {r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s, share of "
                f"bound {r['bound_share']:.3f}), plain {r['plain_ms']:.3f} ms, library (SDPA) "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"max abs err {r['max_abs_err']:.4g}")
        gc.collect()
        torch.cuda.empty_cache()
        llava_hf = llava_hf_phase(work, args.seed)
        DISK.mark("V1")
        llava_generate = llava_generate_phase(llava["artifacts"], args.seed)
        DISK.mark("V3")
        gc.collect()
        torch.cuda.empty_cache()
        seg = packed_segments(work, args.seed)
        gc.collect()
        torch.cuda.empty_cache()
        model = model_check(seg, args.seed)
        gc.collect()
        torch.cuda.empty_cache()
        guards_train = guard_train_phase(seg, args.seed)
        clean = guards_train["clean"]
        log(f"J trainer (2 full-width layers, B=2, S=2048, packed; transfer_guard=raise, "
            f"recompile_budget=2, no prefetch thread, CUDA sync-debug mode armed): "
            f"{J_STEPS} steps, {clean['trips']} trips over {clean['windows']} windows, "
            f"signatures {clean['signatures']}, ms/step "
            f"{[round(x, 1) for x in clean['ms_per_step']]}, flash launches "
            f"{clean['flash_launches']}; with FTC_FAULT_TRANSFER=1 step "
            f"{guards_train['fault']['aborted_at_step']} aborted: "
            f"{guards_train['fault']['error'][:160]}")
        log(f"model check (2 layers, kernel vs plain): loss {model['loss_kernel']:.5f} vs "
            f"{model['loss_plain']:.5f} (rel {model['loss_rel']:.3g}), worst LoRA grad rel "
            f"{model['grad_rel']:.3g}")
        prof = model["profile"]
        if prof["device_ms"] is None:
            log("train-step profile: the profiler recorded no device time (not measured)")
        else:
            log(f"train-step profile (2 layers, forward + backward): {prof['wall_ms']:.1f} ms "
                f"wall, {prof['device_ms']:.1f} ms device, busy {prof['device_busy']:.3f}")
            for name, ms in prof["top"]:
                log(f"  {ms:9.3f} ms  {name}")
            for name, ms in prof["flash"]:
                log(f"  flash kernel {ms:9.3f} ms  {name}")
        gc.collect()
        torch.cuda.empty_cache()
        remat = remat_phase(seg, args.seed)
        t5_launches = {name: sum(r["flash_launches"][name] for r in remat.values())
                       for name in FLASH_KERNELS}
        gc.collect()
        torch.cuda.empty_cache()
        flash = flash_bench(seg, max(4, args.reps // 8), args.seed)
        gc.collect()
        torch.cuda.empty_cache()
        bench = kernel_bench_phase(flash, paged_entry)
        gc.collect()
        torch.cuda.empty_cache()
        DISK.mark("T3, T4, J and B")
        fidelity = phase_finish(fproof)
        DISK.mark("F (joined)")
        packer = native_packer_finish(packer)
        log(f"N native packer: {packer['bytes'] / 1e6:.1f} MB of chat and SFT rows "
            f"({packer['rows']} rows, written in {packer['write_s']:.1f} s) -> "
            f"{packer['blocks']} blocks of 2048: native {packer['native_s']:.2f} s "
            f"({packer['native_mb_per_s']:.1f} MB/s), Python {packer['python_s']:.2f} s "
            f"({packer['python_mb_per_s']:.1f} MB/s, in a subprocess beside phases G-B), "
            f"the arrays bit-equal (SHA-256); T2 took the native path "
            f"({train['native_packs']} packs), C's job log: {control['native_packer_log']!r}")
    except SmokeFailure as e:
        return fail(str(e))
    except (AssertionError, RuntimeError, ValueError) as e:
        return fail(f"training phases: {type(e).__name__}: {e}")
    for name, r in flash.items():
        log(f"{name}: kernel {r['ms']:.4f} ms (mma.sync kernel before {EARLIER_MS[name]} ms), "
            f"plain {r['plain_ms']:.3f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"share of bound {r['bound_share']:.3f}), tiles {r['tiles']}: live-tile share "
            f"{r['live_tile_share']:.3f}, {r['executed_flops'] / 1e9:.1f} GFLOP executed at "
            f"{r['tflops']:.1f} TFLOP/s, max abs err {r['max_abs_err']:.4g} "
            f"(tolerance {fa.TOLERANCE[torch.bfloat16]})")
        log(f"  {name} with no segment ids (every causal tile pair): "
            f"{r['ms_no_segments']:.4f} ms, {r['tflops_no_segments']:.1f} TFLOP/s")
    backward = flash["flash_backward_dq"]["ms"] + flash["flash_backward_dkv"]["ms"]
    log(f"port backward (dQ + dK/dV) {backward:.4f} ms vs SDPA's whole backward "
        f"{flash['flash_backward_dq']['library_ms']:.4f} ms")

    # the record
    src = "finetune_controller_tpu_torch/csrc/flash_attention.cu"
    ref = "finetune_controller_tpu/ops/pallas/flash_attention.py"
    replaces = {"flash_forward": f"{ref}:106", "flash_backward_dq": f"{ref}:315",
                "flash_backward_dkv": f"{ref}:397"}
    kernels = [paged_entry] + [{
        "name": name, "route": "cuda", "source": src, "replaces": replaces[name],
        "launches": (train["launches"][name] + moe["launches"][name]
                     + reward["flash_launches"][name] + rlhf["flash_launches"][name]
                     + remote["flash_launches"][name] + remote["reward_flash_launches"][name]
                     + resilience["flash_launches"][name] + r2_launches[name]
                     + workers["w2"]["flash_launches"][name] + k8s["flash_launches"][name]
                     + t5_launches[name] + tenant["job_flash_launches"][name]
                     + clean["flash_launches"][name]),
        "launches_by_path": {
            "t2_in_process": train["launches"][name],
            "c_job_profile_steps": control["flash_launches_in_profile"][name],
            "d_job_profile_steps": storage["flash_launches_in_profile"][name],
            "m_in_process": moe["launches"][name],
            "v_job_profile_steps": llava["flash_launches_in_profile"][name],
            "p_dpo_job_profile_steps": dpo["flash_launches_in_profile"][name],
            "p_reward_in_process": reward["flash_launches"][name],
            "p_rlhf_learner": rlhf["flash_launches"][name],
            "p4_remote_learner": remote["flash_launches"][name],
            "p4_reward_worker": remote["reward_flash_launches"][name],
            "r_job_both_attempts": resilience["flash_launches"][name],
            "r2_snapshot_in_process": r2_launches[name],
            "w2_warm_job": workers["w2"]["flash_launches"][name],
            "k_pod_trainer": k8s["flash_launches"][name],
            "t5_remat_in_process_all_policies": t5_launches[name],
            "a_job": tenant["job_flash_launches"][name],
            "j_guarded_steps_in_process": clean["flash_launches"][name]},
        "max_abs_err": flash[name]["max_abs_err"],
        "ms": flash[name]["ms"], "plain_ms": flash[name]["plain_ms"],
        "bound_ms": flash[name]["bound_ms"], "bound_by": flash[name]["bound_by"],
        "library_ms": flash[name]["library_ms"],
    } for name in FLASH_KERNELS] + [{
        "name": f"{name}_d256", "route": "cuda", "source": src, "replaces": replaces[name],
        "launches": gemma["flash_launches"][name],
        "launches_by_path": {"g_job": gemma["flash_launches"][name]},
        "tiles": fa.TILES[256][name],
        **{f: gemma["flash_bench"][name][f] for f in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    } for name in FLASH_KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"serve": serve_summary}), flush=True)
    print(json.dumps({"serve_tenants": serve_tenants}), flush=True)
    print(json.dumps({"control": control}), flush=True)
    print(json.dumps({"qlora": {**qlora, "int4_check": int4}}), flush=True)
    print(json.dumps({"moe": moe}), flush=True)
    print(json.dumps({"llava": {"flash_v0": flash_llava, "hf": llava_hf, "job": llava,
                                "generate": llava_generate}}), flush=True)
    print(json.dumps({"prefs": {"p0_objective": dpo_check, "p0_flash": flash_dpo,
                                "p1_dpo_job": dpo, "p2_reward": reward, "p3_rlhf": rlhf,
                                "p4_remote_rlhf": remote}}),
          flush=True)
    print(json.dumps({"hf_io": {"base": hf_base, "merged": merged}}), flush=True)
    print(json.dumps({"fidelity": fidelity}), flush=True)
    print(json.dumps({"resilience": resilience}), flush=True)
    print(json.dumps({"workers": workers}), flush=True)
    print(json.dumps({"storage": storage}), flush=True)
    print(json.dumps({"k8s": k8s}), flush=True)
    print(json.dumps({"gemma": gemma}), flush=True)
    print(json.dumps({"orbax": orbax}), flush=True)
    print(json.dumps({"serve_tenant": tenant}), flush=True)
    print(json.dumps({"guards": {"decode": serve_summary["guards_decode"],
                                 "train": guards_train}}), flush=True)
    print(json.dumps({"native_packer": {k: v for k, v in packer.items() if k != "path"}}),
          flush=True)
    print(json.dumps({"kernel_bench": bench}), flush=True)
    print(json.dumps({"remat": remat}), flush=True)
    print(json.dumps({"train": {**train, "model_check": model, "flash": {
        k: {f: r[f] for f in ("tflops", "bound_share", "live_tile_share", "executed_flops",
                              "ms_no_segments", "tflops_no_segments")}
        for k, r in flash.items()}}}), flush=True)
    log(f"files left on disk: build/chip_smoke_train {tree_bytes(work) / 1e9:.2f} GB, "
        f"build/chip_smoke_ctrl {llava['control_dir_bytes'] / 1e9:.2f} GB; "
        f"{DISK.written() / 2**30:.2f} GiB written in all")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
