#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     build every CUDA kernel of the paths from the checkout's sources (the
     fused epoch and flash attention), all ``nvcc`` processes started
     together, and time the build;
  2. every kernel against its plain PyTorch version, in float32 with TF32
     off and in bfloat16:
     - the fused epoch, on seeded data and flax-shaped weights with dropout
       on and no shuffle: at a small shape (3 clients x 40 samples, 12x12, 5
       classes), where every element must be within the tolerance (see
       TOL), and at the flagship shape (10 clients x 200 samples, 28x28, 62
       classes, batch 20), where two runs must also agree bit for bit (a
       copy one bit off must fail); then the kernel's and the plain
       version's time at the flagship shape (median of 7 timed calls after
       2 warm-up calls, CUDA events) and the least time the card could take
       (the bound); the ptxas report must show no spill in its conv2
       tensor-core kernels;
     - the three flash-attention kernels (forward, dQ, dK/dV), causal and
       not, at the NWP slice's shape (B 16, T 20, H 4, D 32), a ragged
       multi-tile shape (2, 333, 2, 64), a long causal shape (8, 2048, 4,
       32), a ragged narrow shape (2, 100, 3, 20: D no multiple of 8,
       40-byte bf16 rows, so the forward stages with 8-byte copies) and a
       wide odd one (2, 70, 2, 127: the D <= 128 instantiations, float32
       reloading Q's fragments per tile, bf16 rows of odd length copied
       element by element), every element within ATTN_TOL; the three
       kernels again on q, k, v cut from one [B, T, 3H, D] tensor as the
       model cuts them (dO contiguous), which must give the same bits;
       faulted results (O without the causal mask, dQ with one key tile
       dropped, dK and dV swapped, O and dK one bit off) must fail the same
       checks; under the profiler, the forward on such views must run one
       kernel and no copy, and the backward (``flash_bwd``) the delta op's
       kernels, one dQ and one dK/dV kernel, and no layout copy; at shapes
       (a) and (c) each kernel's time, its plain version's, its bound and
       the time of PyTorch's ``scaled_dot_product_attention`` forward or
       backward; the ptxas report must show no spill in any flash
       instantiation with D <= 64 (a spill at D = 128 is printed);
  3. the main paths through the user's entry points:
     - FEMNIST: the surrogate (100 clients, a cut from the reference's 3400
       to keep the surrogate's host memory small; every client capped at
       200 samples, as bench.py's _capped does, because the surrogate is
       ragged and the fused path needs a padded width that is a multiple
       of the batch), FedAvgAPI with the fused kernel for 5 rounds, then
       the same with the engine path;
     - StackOverflow NWP: the surrogate (200 clients), the transformer LM
       at full width (vocab 10,004, d_model 128, 4 heads, 2 layers),
       NWPTrainer, 50 clients a round, batch 16, lr 0.3, 5 rounds;
     each checked for finite parameters, a falling training loss, and every
     kernel of the path launched (counts set to 0 just before the run, read
     just after);
  4. the server rules and client optimizers, each run through FedAvgAPI or
     its CLI with the launch counts read as in phase 3:
     - NWP with FedAdam (server Adam, lr 1e-2) at the widths of phase 3 for
       5 rounds: the loss falls, all three flash kernels launch; the median
       round, the aggregator call's device time (CUDA events around it) and
       the server step's alone beside its bound;
     - fused FEMNIST: FedOpt with server SGD at lr 1 against FedAvg (max
       difference under 1e-6) and FedNova against FedAvg (equal taus; under
       1e-4), 2 rounds, each started from the same globals; 5 rounds of
       FedYogi (the loss falls; the server step timed as for NWP), and the
       robust CLI (``main_fedavg_robust``) with one attacker: finite losses
       and the backdoor metrics printed;
     - engine FEMNIST: client momentum 0.9, wd 1e-4 and FedProx mu 0.01
       under FedNova, then client Adam (AMSGrad, lr 1e-3), 2 rounds each:
       finite parameters and a falling loss;
  5. FedML's benchmark rows beyond FEMNIST through FedAvgAPI or the CLI
     (``experiments/profile_zoo.py`` builds them through the CLI's
     ``setup_run`` from their configs' flags, on the seeded surrogates), each with the four kernels' launches
     counted (none of them is on these paths: each must read 0):
     - cross-silo CIFAR-10 ResNet-56 (``cross_silo_cifar10_resnet56.yaml``:
       10 silos, hetero alpha 0.5, batch 64, SGD lr 0.001, momentum 0.9, wd
       1e-4, float32): first under FedAvgM (server SGD, lr 1, momentum 0.9)
       beside FedAvg, 2 rounds of 1 local epoch, each round from the same
       globals with cuDNN deterministic: the BatchNorm statistics equal
       FedAvg's weighted mean within 1e-6 (the aggregator acts on
       parameters only); then 2 FedAvg rounds of XS_EPOCHS (1) local
       epoch (the config's 20 cut; a round over 30 s is reported):
       the loss falls, every global BatchNorm statistic moved from its init
       and is finite, and the evaluation reads the running statistics (an
       eval-mode call returns no new state, and resetting the statistics
       changes Test/Loss); 2 bf16 rounds of 1 epoch (XS_BF16_EPOCHS) from
       the float32 globals, whose loss falls from the first to the second;
       and a 1-epoch round of one silo (XS_PROFILED_SILOS) under the
       profiler;
     - fed_CIFAR-100 ResNet-18-GN (``fed_cifar100_resnet18_gn.yaml`` under
       ``backend vmap``): 500 clients, 10 a round, batch 20, lr 0.1, 3
       rounds: finite, every global moved (its loss need not fall: this
       config barely learns in a run, see ``run_zoo_paths``);
     - Shakespeare (``shakespeare_rnn.yaml``): the LSTM, 715 clients, 10 a
       round, batch 10, lr 0.8, 3 rounds; then fed_shakespeare per
       position through NWPTrainer, 2 rounds;
     - the CLI with its defaults, ``main_fedavg.main([])`` on the card
       (MNIST logistic regression, 10 clients, 10 rounds);
     each with its median round, its training loss per round and, for one
     more round under ``torch.profiler``, the device's busy share and its
     largest kinds of kernel;
  6. the drive (``FedAvgAPI.train`` as the CLI drives it), each run's
     launches counted as in phase 3, with the tracer's phase spans
     (``stage``, ``h2d``, ``dispatch``, ``device_wait``, ``metrics_fetch``)
     printed as medians beside the median round and the wall per round:
     - fused FEMNIST, 5 rounds at depth 0 (the eager loop) and at
       PIPE_DEPTH (2, the CLI's default): the globals and server state bit
       for bit equal and the kernel launched once a round in each; 3 rounds
       with a checkpoint, then a new ``FedAvgAPI`` restored from it for 2
       more: bit for bit the 5 straight rounds; a pipelined run with one
       staged byte flipped must differ;
     - engine FEMNIST through the CLI with ``--chaos 1 --chaos_drop_rate
       0.3 --chaos_nan_rate 0.3 --guard 1`` (the chaos seed the first that
       NaN-faults a client in the last round): ``quarantined_count >= 1``
       in ``wandb-summary.json``, a ``guard_verdict`` event a round in
       ``TRACE.jsonl``, finite globals in the final checkpoint;
     - NWP at full width, 3 rounds at depth 0 and at PIPE_DEPTH, round 1
       NaN-faulting one client (out-of-range token ids): that client is
       quarantined and no other, no device assert, the loss falls and the
       three flash kernels launch.

  7. the FEMNIST flagship at its configured size (``fedavg_femnist.yaml``:
     3400 clients, 10 a round, batch 20, E = 1, SGD lr 0.1, clip 1.0,
     float32), its train and test splits in mmap shard stores
     (``data/packed_store.py``) in a temporary directory:
     - the disk's free space checked and printed; the uncapped surrogate
       (seed 0) written a chunk of STORE_CHUNK clients at a time by a
       spawned process, never as the padded 5.12 GB array; the build's
       seconds, the store's bytes and the build's peak RSS printed;
     - the fused path through ``FedAvgAPI.train`` at PIPE_DEPTH for
       FLAGSHIP_ROUNDS rounds (cut from the config's 1500; evaluated at
       round 0, as every drive is, and at the last): the kernel launched
       once a round, finite globals, a falling loss; the round spacing and
       the spans printed;
     - the kernel against its plain version at the store's padded width,
       10 x 480 rows (24 steps), float32 within TOL_480 with its faulted
       copies and a one-bit fault rejected, bfloat16 read; both timed with
       their bound;
     - the engine path from the same store at PIPE_DEPTH with
       ``fast_sampling``, FLAGSHIP_ENGINE_ROUNDS rounds (cut from 1500),
       evaluated at round 0 and the last;
     - the sync check: one round each of the fused path, the engine path
       with a chaos participation mask (a client NaN-faulted) and NWP at
       phase 3's widths, dispatched under
       ``torch.cuda.set_sync_debug_mode("error")``: any host sync inside
       the round fails;
     - ``experiments/scale_rss.py`` at 10k, 100k and 1M clients: each
       point's peak RSS and rounds per second, and the ratio of the last
       point's peak to the one before, which must stay within
       SCALE_RSS_RATIO.

  8. the launcher (``experiments/fed_launch.py``) over the repo's 26 YAML
     configs (``fedml_tpu/experiments/configs/`` and its ``baseline/``,
     read as data), each through ``fed_launch.main`` on the card for one
     round, with the cuts of PHASE8_CUTS:
     - the 25 configs the port runs, as written otherwise (the FEMNIST and
       fed_CIFAR-100 configs with their ``backend: shard_map``, on the
       card's one device): the dataset, model and trainer the launcher
       built must be the CLI dispatch's (``cnn`` on har is HAR_CNN, on
       cifar10 CNNCifar), the training loss and the globals finite, and no
       kernel launched;
     - ``fedavg_femnist.yaml`` again with ``fused_kernel=1``: the fused
       epoch must launch;
     - a temporary ``fednas`` config with a ``multihost:`` block must
       raise NotImplementedError naming ROADMAP (``privacy_blockensemble.yaml``
       runs in phase 9);
     - BASELINE.md's cross-silo rows on ``cross_silo_cifar10_resnet56.yaml``
       (1 round of E = 1 over XS_SILOS of 10 silos): MobileNet on CIFAR-10,
       CIFAR-100 and CINIC-10, ResNet-56 on CINIC-10, VGG-11, MobileNetV3
       (LARGE) and EfficientNet-b0 on CIFAR-10, in float32, and MobileNet,
       MobileNetV3 and EfficientNet in bf16; one more float32 round of each
       new model under the profiler (device activity only) for its
       launches and the device's busy share;
     each run prints a line: config, overrides, round ms, Test/Loss before
     and after, training loss, launches. ``--launcher-only`` builds the
     kernels and runs this phase alone.

  9. the fork's privacy package (``privacy/``, ``models/ensemble.py``,
     ``experiments/main_privacy.py``), each run through ``main_privacy`` as
     the launcher resolves ``privacy_blockensemble.yaml``, with the four
     kernels' launches counted (none is on these paths: each must read 0)
     and every branch finite:
     - cell 15, the config with PRIVACY_CUTS: the 4-branch block
       ensemble, 10 (of 50) rounds of 10 of 10 MNIST clients, E = 1, batch 32, lr
       0.1, 2 paths trained jointly, then the MI report; the training loss
       must fall; the median round, Train/Loss at the first and last round,
       the ensemble's and each branch's accuracy, every ``MI/*`` metric and
       the report's seconds printed; one more round under the profiler
       (device activity only) for its launches and the busy share;
     - the same config for PRIVACY_SHORT_ROUNDS rounds with 3 paths and
       feat_lmda 0.5 (ThreeModelTrainer, feature matching), and one bf16
       round;
     - cell 16: ``--ensemble_method`` predavg (with the MI report),
       predvote, predweight, blockavg and hetero, 4 branches,
       PRIVACY_SHORT_ROUNDS rounds each;
     - checks on predavg's branch 0: per-sample gradient norms from
       ``vmap`` equal a loop of ``torch.autograd.grad`` at 16 samples
       (float32, rtol 1e-5); the penultimate gradient's closed form equals
       autograd's gradient with respect to the head's input; with members
       and non-members the same tensors the NN and loss attacks read
       advantage exactly 0; robust accuracy at eps 0 equals the ensemble's
       plain accuracy; the MI report's per-sample gradients at 512 rows
       timed, with their peak device memory;
     the phase's seconds against PHASE9_BUDGET_S. ``--privacy-only`` builds
     the kernels and runs this phase alone.
 10. the transport and asynchronous axes of the FedAvg drive, within
     PHASE10_BUDGET_S (``--transport-only`` builds the kernels and runs this
     phase alone):
     - (a) cell 17, the codecs on the flagship engine (cell 1's config and
       cut): ``update_codec`` int8 and top-k (k 64), CODEC_ROUNDS rounds
       each, the globals' Train/Loss falling and the globals finite; the
       residual identity decode(payload) + new residual == update +
       residual bit for bit on the card; ``update_codec="none"`` with no
       codec in the state, and its run repeated bit for bit (the phase runs
       on cuDNN's deterministic algorithms: with its default ones two engine
       runs differ in their last bits);
     - (b) cell 2 with int8, 2 rounds, the three flash kernels' launches
       counted (0 fails);
     - (c) cell 18, FedBuff on the flagship engine: the degenerate buffer
       (size 10 = cohort, alpha 0) bit for bit the synchronous round over 3
       rounds; then buffer 5, alpha 0.5 under the straggler plan (rate 0.3,
       1-2 rounds late) over BUFF_ROUNDS dispatch rounds, twice, bit for
       bit: commits, staleness p50 and max, round time;
     - (d) cell 19, the superstep: rounds_per_dispatch SUPERSTEP_K with
       ``fast_sampling`` (Feistel cohorts drawn on the host, gathered on the
       card) and int8 over round 0
       (an eval round, eager) and SUPERSTEP_ROUNDS rounds in
       SUPERSTEP_ROUNDS / SUPERSTEP_K dispatches, bit for bit the eager loop,
       and one dispatch under ``torch.cuda.set_sync_debug_mode("error")``
       (a ``.item()`` after it must raise); each round's time beside the
       eager round's; cell 2 at 2 rounds a dispatch (round 0 eager, rounds
       1-2 one dispatch) with the flash launches counted; the device
       sampler against the host's for 3400 clients over SAMPLER_ROUNDS
       rounds.
 11. federated LoRA, the client ledger, the personal adapter bank and the
     multi-tenant scheduler, within PHASE11_BUDGET_S (``--serving-only``
     builds the kernels, runs phase 3's NWP path for its launch counts, then
     this phase alone), on cuDNN's deterministic algorithms:
     - (a) cell 20, cell 2 with ``lora_rank`` 8 at depth 2 for LORA_ROUNDS
       rounds: the loss falls, each flash kernel's launches within 15% of
       phase 3's NWP path, the frozen base bit for bit its initial value,
       the wire tree (the adapters) 32,768 parameters, the adapters-only
       checkpoint of round 3 resumed to round 5 bit for bit the run, and one
       more round dispatched under ``set_sync_debug_mode("error")``;
     - (b) cell 21, (a) personalized from an adapter bank with a client
       ledger attached and chaos drops at PFL_DROP_RATE: the pipelined run
       and an eager resume of its round-3 checkpoint (with its bank and
       ledger files as they stood then) to round 5, bit for bit (globals,
       records, bank and ledger files); every dropped client's row
       scattered back as it was gathered and live rows changed;
       ``Personalization/Lift`` finite; a sync-checked dispatch;
       ``adapter_clusters`` 4 for 2 rounds on a 4-row bank; then a bank of
       StackOverflow's BIG_BANK_ROWS train clients (sparse, 44.9 GB
       logical): BANK_CYCLES random BANK_COHORT-row gather and scatter
       cycles through ``AdapterBank.apply``, the physical bytes equal to
       the touched rows' pages, the sampled RSS growing by under
       RSS_GROWTH_MB MB, rows a second printed (where a probe shows the
       filesystem reporting a truncated file's holes as allocated: at
       SMALL_BANK_ROWS rows, said so, and the RSS and rate alone checked);
     - (c) cell 22, three tenants under one ``Scheduler`` (fair share,
       ``max_resident`` 2, spilled evictions): cell 1's engine (sync, 4
       rounds), cell 18's FedBuff with stragglers in partial dispatch (4
       rounds) and (b)'s personalized tenant (3 rounds, latency-bound with
       a deadline), submitted after two ticks so that it preempts: each
       tenant's final parameters bit for bit its solo run's, at least one
       eviction, the card's allocated bytes falling at each, ``check_slo``'s
       report, a compile ledger of zeros, flash launches only in the NWP
       tenant and the fused kernel nowhere; a submission past
       ``max_queued`` 1 under ``admission="reject"`` bounces.

 12. the FedAvg family's last datasets, within PHASE12_BUDGET_S
     (``--datasets-only`` builds the kernels and runs this phase alone), on
     cuDNN's deterministic algorithms, every path's launches of the four
     kernels counted and printed (each must read 0: none is on these
     paths), its cuts of scale in PHASE12_CUTS; whether PIL imports is
     printed first (the streaming paths decode JPEG trees with it, and
     fail without it):
     - (a) cell 23, stackoverflow_lr with ``lr`` at full width (10,000
       words -> 500 tags) on its 200 surrogate clients, 10 a round, 3
       rounds, TagPredictionTrainer: the BCE falls, the test precision and
       recall in [0, 1], no ``correct`` sum in the records; round times
       and one profiled round's device-busy share;
     - (b) cell 24, rank-8 LoRA over ``rnn_stackoverflow``'s gate kernels
       (embedding 96, one LSTM of 670, vocab 10,004) on cell 2's data, 50
       clients a round, batch 16, 3 rounds at depth 2: the frozen base bit
       for bit, the wire's parameters beside the model's, the training loss
       and the global test loss (before and after) fall; then one LoRA
       round of the Shakespeare LSTM;
     - (c) cell 25, gld23k streamed at its federation (233 users, 203
       classes, 23,080 rows at 64 px over GLD_POOL distinct seeded images)
       in the loader's csv layout, ``mobilenet_v3``, 10 users a round, 3
       rounds, evaluating in CI mode (STREAM_EVAL_CI), under a
       STREAM_BUDGET byte budget: after every ``select``
       of either split the resident bytes within the budget, the sampled
       clients resident and every resident client sampled; evictions;
       per round its time, its ``stage`` span and the peak RSS;
     - (d) cell 26, one ILSVRC2012 round at 224 px with ``resnet18_gn``:
       100 class-blocked clients over 1,000 classes (INET_TRAIN_PER_CLASS
       images a class), 10 sampled, the checks of (c);
     - (e) cell 27, one CIFAR-10 ResNet-20 round with
       ``cifar_train_augment`` as the trainer's ``augment_fn``, its draws
       from the clients' generators on the card, run twice: bit for bit;
       an augmented batch differs from its input.

 13. the algorithm zoo's first four, within PHASE13_BUDGET_S
     (``--algorithms-only`` builds the kernels and runs this phase alone),
     on cuDNN's deterministic algorithms, every path's launches of the four
     kernels counted and printed (each must read 0: none is on these
     paths), its cuts of scale in PHASE13_CUTS:
     - (a) cell 28, hierarchical FL with ``CNN_DropOut`` on phase 3's
       FEMNIST data (100 clients, at most 200 samples each), batch 20, lr
       0.1, clip 1.0, 2 groups, 2 inner rounds over every client, 2
       rounds: the training loss falls and the globals are finite; the
       round times and a profiled round's busy share and launches (on
       HIER_PROFILED_CLIENTS clients);
     - (b) the JAX package's CI oracles on MNIST lr, 12 clients, full
       batch: 1 group and 1 inner round within 1e-5 of the FedAvg engine
       round, 3 groups within 2e-3 of centralized GD (Test/Acc, Test/Loss);
     - (c) cell 29, the centralized trainer on (a)'s union (11,042 rows),
       batch 20, 2 rounds: the round times, Test/Acc and Test/Loss;
     - (d) cell 30, TurboAggregate on phase 3's engine configuration (10
       of 100 clients a round, 1.2 M parameters), 2 groups, the default
       threshold, frac_bits 16, TA_ROUNDS rounds: per round the host seconds of
       the quantize, encode and decode, the bytes copied each way, the
       round time; the secure global within 4 * 2^-16 of the plain mean
       of the same host trees under the same rounded weights, and the
       global on the card the secure sum bit for bit;
     - (e) cell 31, decentralized at the JAX main's defaults (8 nodes, 100
       iterations, dim 20, 4 neighbors, 2-class lr): DSGD on the symmetric
       ring and push-sum on the asymmetric one, the online loss falling
       (the last 5 iterations' mean under the first 5's), the DSGD
       consensus spread under 0.05; one fully-connected step the node
       average within 1e-6;
     - (f) ``main_base``'s defaults give exactly [6, 10, 14], and
       ``base``, ``hierarchical``, ``decentralized`` and ``turboaggregate``
       each run through ``fed_launch`` from a YAML, 1 round.

 14. FedML's split-learning family, within PHASE14_BUDGET_S
     (``--split-only`` builds the kernels and runs this phase alone), on
     cuDNN's deterministic algorithms, every path's launches of the four
     kernels counted and printed (each must read 0: none is on these
     paths), its cuts of scale in PHASE14_CUTS:
     - (a) cell 32, FedGKT through ``main_fedgkt`` at full width (the
       ResNet-8 edge, num_blocks 1; the (5, 6, 6) ResNet-55 server) on the
       CIFAR-10 surrogate: 8 hetero clients capped at GKT_CAP rows, batch
       64, 1 local epoch, 2 server epochs, T 3.0, alpha 1.0, GKT_ROUNDS of
       the main's 10 rounds: each round's client-phase and server-phase
       seconds, the bytes of the features on the card, the server's epoch
       losses (finite, the last under the first) and Test/Acc; then a 1 + 1
       run resumed from its checkpoint, bit for bit the straight run
       (every client's and the server's variables, both optimizers'
       states, the server logits);
     - (b) cell 33, SplitNN through ``main_split_nn`` at ``--split_width
       16`` on the CIFAR-10 surrogate, 4 clients, batch 32, 1 epoch, lr
       SPLIT_LR, SPLIT_CYCLES relay cycles: the cycle times, Train/Acc, Train/Loss and
       Test/Acc, all finite;
     - (c) cell 34, vertical FL through ``main_vfl``: lending club's
       surrogate with ``--model dense`` (4 epochs, batch 64, lr 0.05;
       Test/Acc > 0.7) and ``--model lr``, NUS-WIDE's with three parties;
       then one ``NeuralVFLAPI.fit`` epoch at the API's defaults over
       VFL_ROWS rows of ``synthetic_vfl_parties((634, 500, 500))``, its
       steps a second, its last 50 steps' mean loss under its first 50's;
     - (d) ``fedgkt``, ``split_nn`` and ``vfl`` each run through
       ``fed_launch`` from a YAML, 1 round or epoch; a ``fednas`` config
       with a ``multihost:`` block still raises.

 15. FedNAS and FedSeg, within PHASE15_BUDGET_S (``--search-seg-only``
     builds the kernels and runs this phase alone), on cuDNN's
     deterministic algorithms, every path's launches of the four kernels
     counted and printed (each must read 0: none is on these paths), its
     cuts of scale in PHASE15_CUTS:
     - (a) cell 35, FedNAS at DARTS's CIFAR-10 search widths (16 channels,
       8 cells, steps 4, multiplier 4) on the CIFAR-10 surrogate: 4 homo
       clients capped at NAS_CAP rows, batch 64, E 1, lr 0.025 cosine to
       1e-3, momentum 0.9, wd 3e-4, arch lr 3e-4, first order with
       lambda_train 1, NAS_ROUNDS rounds: each round's seconds,
       search_loss, search_acc and search_samples (4 x NAS_CAP / 2), the
       genotype, ``evaluate()``'s Test/Acc and the peak memory; a run
       resumed from the checkpoint of round 1 (1 + 1), bit for bit the
       straight one (params, alphas, both optimizer states, the
       genotypes and records); one
       first-order, one ``unrolled=True`` and one ``gdas=True`` step at
       the same widths and batch, each timed with its peak memory and a
       finite loss; one bfloat16 round with a finite loss;
     - (b) cell 36, FedSeg through ``main_fedseg``: DeepLabV3+ at width 32
       on the 64 px pascal_voc surrogate, 4 clients, batch 8, lr 0.007,
       SEG_ROUNDS rounds, evaluated every round: the round seconds and
       Test/accuracy, accuracy_class, mIoU and FWIoU, all finite; a
       ``FedSegAPI`` run resumed from the checkpoint of round 1 (1 + 1),
       bit for bit the straight one; then two rounds at 128 px and width 64 (the
       compute-bound rung), in float32 and in bfloat16, each timed;
     - (c) one ``main_fedseg --model fcn --loss_type focal`` round;
     - (d) ``fednas`` (the JAX main's widths, 4 CIFAR-10 surrogate
       clients) and ``fedseg`` each run through ``fed_launch`` from a
       YAML, 1 round.

 16. The silo-grouped round and FedAvg over MQTT, within PHASE16_BUDGET_S
     (``--silo-mqtt-only`` builds the kernels and runs this phase alone),
     on cuDNN's deterministic algorithms, every path's launches of the
     four kernels counted and printed (each must read 0: none is on these
     paths), its cuts of scale in PHASE16_CUTS:
     - (a) cell 37, ``cross_silo_cifar10_resnet56.yaml``'s ResNet-56
       (widths 16/32/64) over its 10 hetero CIFAR-10 silos, batch 64, SGD
       with momentum 0.9 and wd 1e-4, E = 1, every silo capped at SILO_CAP
       rows: ``FedAvgAPI`` with ``silo_threshold`` 32 (the silo-grouped
       round) against the same API on the engine round, SILO_ROUNDS rounds
       each in lockstep from the same globals and round generators, the
       second under the profiler (``profile_zoo.profiled_round``: launches,
       busy share, the kernels of most time); beside them the rounding
       witness, the silo round at 32 on cuDNN's fastest algorithms
       (nondeterministic ones among them); after each round every leaf of
       the silo round's globals within LEAF_TOL of the engine round's,
       and all leaves pooled within POOLED_TOL (``leaf_gaps``), the
       witness's gap to the silo round printed beside; the round ms and
       the peak device bytes of each path; then one round at threshold 64,
       timed, and within the same limits of threshold 32's first round;
     - (b) cell 38, ``main_mqtt_fedavg`` on the FEMNIST surrogate with
       ``CNN_DropOut`` (1,206,590 parameters), MQTT_WORKERS workers,
       MQTT_ROUNDS rounds, the in-process broker on loopback, each worker's
       local SGD on the card: the payload bytes a message, the seconds a
       round spent encoding, publishing, decoding and training (the
       tracer's spans), the loopback relay of one payload-sized message;
       every model a worker decoded equals the server's of that round bit
       for bit; the test losses finite.

The script's wall time, then the last three lines: the card's name and
power limit, a JSON object of per-kernel numbers, and ``{"ok": true,
"device": {...}}``.

    python3 chip_smoke.py --calibrate 5

prints instead the readings of the fused epoch against its plain version
at the flagship shape for seeds 0-4, one JSON line each, from which the
limits in TOL are set.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
CLIENTS, SAMPLES, BATCH, SIDE, CLASSES = 10, 200, 20, 28, 62
FEMNIST_CLIENTS, CAP, ROUNDS = 100, 200, 5
# H100 SXM peaks (NVIDIA data sheet, dense), one table for every kernel:
# float32 at the card's fastest route to float32 accuracy, 3xTF32 (three
# TF32 products per float32 product at 495 TFLOP/s, which the flash kernels
# and the fused epoch's conv2 products run); bf16 on the tensor cores; HBM3
# bandwidth
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# Kernel vs plain version, both float32-accumulating in different orders.
# Elementwise (rtol, atol): float32 is the JAX kernel's own contract
# (tests/test_fused_sgd.py:76-81); bfloat16 rounds at the same points on both
# sides, but a float32 sum taken in another order can land on the other side
# of a bf16 rounding step (2**-8 relative). At the small shape every element
# must pass. At the flagship shape an epoch makes ~10**8 ReLU and max-pool
# decisions, and a few sit within rounding of their threshold: there the two
# sides route a whole gradient element differently and that client's later
# steps drift apart. So at the flagship shape
#   - a fraction ``outliers`` of the elements may miss (rtol, atol), but no
#     element may differ by more than ``max_abs``;
#   - per leaf, the median over clients of ||kernel - plain|| / ||plain -
#     global|| (the difference over the client's own update) stays within
#     ``rel_median``, and every client's within ``rel_max``: a leaf the
#     kernel left un-updated reads 1 there;
#   - the loss sums agree to ``loss`` relative.
# The limits were set at about 10x the largest reading of sound runs over
# seeds 0-4 with the kernel's earlier SIMT conv2 (``--calibrate 5`` on an H100
# 80GB HBM3: float32 max_abs 4.1e-5, outliers 1.4e-5, rel_median 9.0e-6,
# rel_max 3.2e-3; bfloat16 max_abs 2.5e-3, outliers 1.1e-3, rel_median
# 4.8e-4, rel_max 0.24), except bfloat16's rel_max, held below the 1 of a
# skipped leaf. With conv2 on the tensor cores ``--calibrate 5`` reads (H100
# 80GB HBM3 at 700 W): float32 max_abs 1.3e-4, outliers 3.7e-5,
# rel_median 8.0e-6, rel_max 9.4e-3, loss 9.4e-7; bfloat16 max_abs 2.5e-3,
# outliers 1.1e-3, rel_median 3.6e-4, rel_max 0.24, loss 6.1e-4.
# ``check_controls`` shows that a kernel that skips the update, or one leaf's
# update, fails them.
TOL = {"float32": {"rtol": 2e-5, "atol": 1e-5, "outliers": 1e-4, "max_abs": 4e-4,
                   "rel_median": 1e-4, "rel_max": 0.03, "loss": 1e-4},
       "bfloat16": {"rtol": 1e-3, "atol": 2e-4, "outliers": 1e-2, "max_abs": 2.5e-2,
                    "rel_median": 5e-3, "rel_max": 0.6, "loss": 5e-3}}
# Phase 7 holds the kernel at the flagship store's padded width, 10 x 480
# rows: 24 SGD steps a client, where TOL's shape runs 10. A flipped ReLU or
# max-pool decision grows step by step (lr 0.1), so after 24 steps a client
# can drift far from the plain version's: ``--calibrate 5`` at 10 x 480
# (H100 80GB HBM3 at 700 W) read float32 max_abs 8.9e-3, outliers 8.8e-2
# (a fraction of elements: whole clients that drifted), rel_median 2.8e-3,
# rel_max 0.43, loss 8.5e-4; bfloat16 rel_median up to 0.34 and rel_max
# 0.88. TOL_480 holds float32 (the flagship's type) at about 10x those
# readings, except rel_max, held below the 1 of a skipped leaf as TOL's
# bfloat16 is; ``check_controls`` and a one-bit fault show that it still
# rejects a kernel that skips an update. bfloat16 at 24 steps has no limit
# under that 1 with room over its readings: it is timed and its readings are
# printed, and phase 2 holds it at 10 x 200.
TOL_480 = {"rtol": 2e-5, "atol": 1e-5, "outliers": 0.9, "max_abs": 0.09,
           "rel_median": 0.028, "rel_max": 0.9, "loss": 8.5e-3}


# Flash attention: check shapes (B, T, H, D) and elementwise (rtol, atol)
# of kernel vs plain version. float32 is the JAX package's own contract
# (tests/test_sequence.py:51 for O, :153 for the gradients), lse included.
# bfloat16: both sides compute in float32 from the same bf16 inputs and
# round the outputs once, so an element may differ by one bf16 step (2**-7
# relative at most) where the two float32 values straddle a rounding
# point; lse stays float32 on both sides.
ATTN_SHAPES = {"a": (16, 20, 4, 32), "b": (2, 333, 2, 64), "c": (8, 2048, 4, 32),
               "d": (2, 100, 3, 20), "e": (2, 70, 2, 127)}
ATTN_TOL = {"float32": {"o": (2e-5, 2e-5), "lse": (2e-5, 2e-5), "grad": (2e-4, 2e-4)},
            "bfloat16": {"o": (1e-2, 1e-4), "lse": (2e-5, 2e-5), "grad": (1e-2, 2e-4)}}
NWP_CLIENTS, NWP_PER_ROUND, NWP_BATCH, NWP_LR = 200, 50, 16, 0.3
# Phase 6: the CLI's default pipeline depth, and the tracer's phase spans
PIPE_DEPTH = 2
DRIVE_SPANS = ("stage_wait", "stage", "h2d", "dispatch", "device_wait", "metrics_fetch",
               "eval")
# the fused timing pair runs longer than ROUNDS, so that the pipeline
# reaches its steady state between the evaluations of its first and last
# round
TIME_ROUNDS = 20
# Cross-silo ResNet-56: the config's 20 local epochs cut to XS_EPOCHS (E = 3
# rounds took 20.3-21.3 s each and the whole script 1,003.1 s with phase 13,
# E = 2 rounds 16.4-17.2 s and the script 1,083.1 s on a slower host, on an
# H100 80GB HBM3 at 700 W: cut to 1 to keep the script under 1,000 s; the
# launcher's adult, purchase and texas configs still run E = 5 on the card;
# 3 was the most whose round stayed within XS_ROUND_S, 28.6-29.9 s on the
# slowest host); a longer round is reported, not re-cut. The
# FedAvgM/FedAvg pair checks the aggregator, not local depth: 1 epoch. The
# bf16 rounds check the type, not local depth either: 1 epoch (3 took 27.5-
# 31.1 s a round, about 40 s of the script, on an H100 80GB HBM3 at 700 W).
# The profiled 1-epoch round runs XS_PROFILED_SILOS of the 10 silos.
XS_EPOCHS, XS_ROUND_S, XS_PAIR_EPOCHS, XS_BF16_EPOCHS, XS_PROFILED_SILOS = 1, 30.0, 1, 1, 1
# Phase 7: the FEMNIST flagship at its configured 3400 clients, from an mmap
# shard store. The surrogate's largest client has 480 samples (its clip), so
# the padded width is 480 rows: 24 SGD steps a client through the fused
# kernel. FLAGSHIP_ROUNDS fused rounds, FLAGSHIP_ENGINE_ROUNDS engine rounds;
# the store is written STORE_CHUNK clients at a time.
FLAGSHIP_CLIENTS, FLAGSHIP_SAMPLES = 3400, 480
FLAGSHIP_ROUNDS, FLAGSHIP_ENGINE_ROUNDS, STORE_CHUNK = 12, 3, 64
# experiments/scale_rss.py's points (the JAX tools/bench_scale.py sweep); a
# peak RSS of the last point over 1.25x the one before fails the phase:
# staging is O(cohort), so the curve must be flat
SCALE_POINTS, SCALE_RSS_RATIO = (10_000, 100_000, 1_000_000), 1.25
# Phase 8: the launcher over the repo's YAML configs (read as data from the
# checkout), one round each, within PHASE8_BUDGET_S. Cuts, from rounds
# measured on an H100 80GB HBM3 at 700 W (host-bound): the local epochs to
# 1 where the config's E made a round over 2 s (chmnist E=5 3.5-4.1 s,
# cifar10_cnn E=10 4.1 s, cifar10_homo_res20 E=5 6.0 s, the four HAR twins
# E=10 3.9-4.6 s, emnist E=5 2.1 s), and the cross-silo ResNet-56's E=20 to
# 1 over XS_SILOS of its 10 silos (5.8-7.2 s a round over all 10, 1.6 s
# over 2); FEMNIST's 3400 clients to PHASE8_FEMNIST_CLIENTS (its surrogate
# takes 14 s of host time and 5 GB a build; phase 7 runs the 3400 from a
# store). cifar10_heter_res20 (E=1, batch 16: 6.5-9.7 s) runs as written.
CONFIG_DIR = "fedml_tpu/experiments/configs"
PHASE8_BUDGET_S = 150.0
PHASE8_FEMNIST_CLIENTS = 340
XS_SILOS = 1
PHASE8_CUTS = {"cross_silo_cifar10_resnet56.yaml": ["epochs=1",
                                                    f"client_num_per_round={XS_SILOS}"],
               "fedavg_femnist.yaml": [f"client_num_in_total={PHASE8_FEMNIST_CLIENTS}"],
               **{name: ["epochs=1"] for name in (
                   "chmnist_heter.yaml", "chmnist_homo.yaml", "cifar10_cnn.yaml",
                   "cifar10_homo_res20.yaml", "har_class_heter.yaml", "har_class_homo.yaml",
                   "har_hetero.yaml", "har_homo.yaml", "emnist.yaml")}}
# BASELINE.md's cross-silo rows (benchmark/README.md:108-111) and the new
# convolutional models, each on cross_silo_cifar10_resnet56.yaml at 1 round
# of 1 local epoch (of 20) over XS_SILOS of its 10 silos (phase 8 ran 158 s
# with 2 silos a float32 round, each profiled round's reading about 10 s of
# it): (overrides, also run in bf16, one more float32 round profiled: each
# new model once; ResNet-56's profile is phase 5's)
CROSS_SILO_ROWS = (
    (("model=mobilenet", "dataset=cifar10"), True, True),
    (("model=mobilenet", "dataset=cifar100"), False, False),
    (("model=mobilenet", "dataset=cinic10"), False, False),
    (("model=resnet56", "dataset=cinic10"), False, False),
    (("model=vgg11", "dataset=cifar10"), False, True),
    (("model=mobilenet_v3", "dataset=cifar10"), True, True),
    (("model=efficientnet", "dataset=cifar10"), True, True),
)
# the module class the CLI's dispatch builds for a config's model name
MODEL_CLASSES = {"lr": "LogisticRegression", "cnn": "CNN_DropOut", "cnn_cifar": "CNNCifar",
                 "har_cnn": "HAR_CNN", "resnet20": "ResNetCifar", "resnet56": "ResNetCifar",
                 "resnet18_gn": "ResNetImageNet", "vgg11": "VGG",
                 "purchasemlp": "ReferenceMLP", "texasmlp": "ReferenceMLP",
                 "rnn": "RNN_OriginalFedAvg", "mobilenet": "MobileNet",
                 "mobilenet_v3": "MobileNetV3", "efficientnet": "EfficientNet"}

# Phase 9: the fork's privacy package. Cell 15 is privacy_blockensemble.yaml
# through the launcher, with PRIVACY_CUTS (10 of 10 MNIST clients, E = 1,
# batch 32, lr 0.1, 4 branches, 2 paths, the MI report), its 50 rounds cut
# to PRIVACY_ROUNDS: uncut, they took 81.1-103 s of the phase's 154-173 s on
# an H100 80GB HBM3 at 700 W (a joint round 1.57-2.07 s), over
# PHASE9_BUDGET_S; then the same config for PRIVACY_SHORT_ROUNDS rounds
# with 3 paths and feature matching, one bf16 round, and cell 16: the five
# branch ensembles, each PRIVACY_SHORT_ROUNDS rounds, within PHASE9_BUDGET_S.
PRIVACY_CONFIG = "privacy_blockensemble.yaml"
PRIVACY_ROUNDS = 10
PRIVACY_CUTS: list = [f"comm_round={PRIVACY_ROUNDS}"]
PRIVACY_SHORT_ROUNDS, PHASE9_BUDGET_S = 5, 120.0
ENSEMBLE_METHODS = ("predavg", "predvote", "predweight", "blockavg", "hetero")
# Phase 10: the codecs, FedBuff and the superstep (cells 17-19) on cell 1's
# engine configuration and cut, and cell 2's
PHASE10_BUDGET_S = 90.0
CODEC_ROUNDS, TOPK_K = 5, 64
BUFF_SIZE, BUFF_ALPHA, BUFF_ROUNDS = 5, 0.5, 8
STRAGGLER_RATE, STRAGGLER_ROUNDS = 0.3, 2
SUPERSTEP_K, SUPERSTEP_ROUNDS, SAMPLER_ROUNDS = 4, 8, 1000
# Phase 11: federated LoRA, personalization and serving (cells 20-22) on cell
# 2's NWP configuration at rank LORA_RANK, and cells 1 and 18 as tenants
PHASE11_BUDGET_S = 120.0
LORA_RANK, LORA_ROUNDS, LORA_WIRE = 8, 5, 32768
LAUNCH_SLACK = 0.15
# StackOverflow NWP's train population (BASELINE.md, the reference's
# benchmark/README.md:59-62): the bank's rows at the federation's real size
BIG_BANK_ROWS, SMALL_BANK_ROWS = 342_477, 10_000
BANK_CYCLES, BANK_COHORT, RSS_GROWTH_MB = 20, 50, 64
SERVE_ROUNDS, PFL_SERVE_ROUNDS, PFL_DEADLINE_S, PFL_DROP_RATE = 4, 3, 600.0, 0.3
# Phase 12: the FedAvg family's last datasets (cells 23-27) at full width,
# each path with the four kernels' launches counted (each must read 0),
# within PHASE12_BUDGET_S. Cuts of scale, each beside its constant:
PHASE12_BUDGET_S = 90.0
# (a) stackoverflow_lr: the surrogate's 200 clients (all of it), 3 rounds
SO_LR_CLIENTS, SO_LR_PER_ROUND, SO_LR_BATCH, SO_LR_LR, SO_LR_ROUNDS = 200, 10, 10, 1.0, 3
# (b) rank-8 LoRA over rnn_stackoverflow on cell 2's data, 3 rounds (of the
# config's 1500), then one round of the Shakespeare LSTM. The adapters of a
# near-uniform random LSTM move its loss by float32 noise in 3 rounds at
# BASELINE.md's lr 10**-0.5 (a CPU probe: 0.4605729 -> 0.4605728); lr 10
# (no published LoRA config names one) makes the fall plain (-> 0.4605620)
LSTM_LORA_ROUNDS, LSTM_LORA_LR = 3, 10.0
# (c) gld23k: its 233 users and 23,080 train rows at 64 px, the rows
# naming GLD_POOL distinct seeded images (each decoded once a row); the
# test csv cut to GLD_TEST_ROWS rows (of 19,526); 3 rounds
GLD_USERS, GLD_CLASSES, GLD_ROWS, GLD_SIDE = 233, 203, 23_080, 64
GLD_POOL, GLD_TEST_ROWS, GLD_PER_ROUND, GLD_ROUNDS, GLD_BATCH, GLD_LR = (
    2_048, 2_330, 10, 3, 32, 0.05)
# (d) ILSVRC2012 at 224 px: 100 class-blocked clients over 1,000 classes,
# INET_TRAIN_PER_CLASS train images a class (of about 1,300) and
# INET_VAL_PER_CLASS val images (of 50), copies of INET_POOL seeded JPEGs;
# one round
INET_CLIENTS, INET_CLASSES, INET_SIDE, INET_POOL = 100, 1000, 224, 256
INET_TRAIN_PER_CLASS, INET_VAL_PER_CLASS, INET_PER_ROUND, INET_BATCH = 2, 1, 10, 20
# both streaming paths decode under this budget, below either federation;
# gld23k evaluates in the JAX config's CI mode (one client's splits): a
# round that evaluated all 233 users' 25,410 rows took 26.1-28.8 s on an
# H100 80GB HBM3 at 700 W, most of it host decodes (ILSVRC2012's one round
# evaluates all 100 clients, and its 3,000 rows are what evict)
STREAM_BUDGET = 256 << 20
STREAM_EVAL_CI = 1
# (e) CIFAR-10 ResNet-20 with the train transform: 10 hetero clients, one
# round, twice
AUG_CLIENTS, AUG_BATCH, AUG_LR = 10, 64, 0.1
PHASE12_CUTS = {
    "stackoverflow_lr": [f"comm_round={SO_LR_ROUNDS}"],
    "lora rnn_stackoverflow": [f"comm_round={LSTM_LORA_ROUNDS}",
                               f"client_num_in_total={NWP_CLIENTS} (of 342,477)"],
    "lora rnn": ["comm_round=1"],
    "gld23k": [f"distinct images {GLD_POOL} (of {GLD_ROWS})",
               f"test rows {GLD_TEST_ROWS} (of 19,526)", f"comm_round={GLD_ROUNDS}",
               f"ci={STREAM_EVAL_CI}"],
    "ILSVRC2012": [f"train images a class {INET_TRAIN_PER_CLASS} (of ~1,300)",
                   f"val images a class {INET_VAL_PER_CLASS} (of 50)",
                   f"distinct images {INET_POOL}", "comm_round=1"],
    "cifar10 augment": ["comm_round=1"],
}
# Phase 13: the algorithm zoo's first four (cells 28-31), each path with the
# four kernels' launches counted (each must read 0: none is on these paths),
# within PHASE13_BUDGET_S, on cuDNN's deterministic algorithms. Cuts of
# scale, each beside its constant:
PHASE13_BUDGET_S = 60.0
# (a) cell 28, hierarchical on phase 3's FEMNIST cut (100 of 3400 clients,
# 200 samples each at most), group_num 2 (the JAX main's default), 2 inner
# rounds, every client training in each; HIER_ROUNDS global rounds (3 took
# 5.5-7.0 s each and phase 13 68.5 s on an H100 80GB HBM3 at 700 W); its
# profiled round on the first HIER_PROFILED_CLIENTS clients (a 100-client
# round makes about 1,200 engine steps, whose device events would take
# tens of seconds to read)
HIER_GROUPS, HIER_INNER, HIER_ROUNDS, HIER_PROFILED_CLIENTS = 2, 2, 2, 10
# (b) the JAX package's CI oracles (tests/test_algorithms.py:109-141): MNIST
# lr on 12 homo clients at full batch
ORACLE_CLIENTS = 12
# (c) cell 29, centralized on (a)'s union (its clients' valid rows), batch 20
CENTRAL_ROUNDS = 2
# (d) cell 30, TurboAggregate on phase 3's engine configuration (10 of the
# 100 clients a round), the default threshold, TA_ROUNDS rounds (2 took
# 8.3-11.6 s each, 7.2-10.7 s of it the host's encode, and phase 13 63.5-68.5
# s, the whole script 1,003.1 s, on an H100 80GB HBM3 at 700 W: cut to 1)
TA_GROUPS, TA_FRAC_BITS, TA_ROUNDS = 2, 16, 1
# (e) cell 31, decentralized at the JAX main's defaults
DEC_NODES, DEC_ITERATIONS, DEC_DIM, DEC_NEIGHBORS, DEC_LR = 8, 100, 20, 4, 0.1
PHASE13_CUTS = {
    "hierarchical": [f"client_num_in_total={FEMNIST_CLIENTS} (of 3400)",
                     f"samples a client <= {CAP}", f"comm_round={HIER_ROUNDS}",
                     f"profiled round on {HIER_PROFILED_CLIENTS} clients"],
    "centralized": [f"the union of {FEMNIST_CLIENTS} clients' rows",
                    f"comm_round={CENTRAL_ROUNDS}"],
    "turboaggregate": [f"client_num_in_total={FEMNIST_CLIENTS} (of 3400)",
                       f"comm_round={TA_ROUNDS}"],
    "launcher": ["comm_round=1", "decentralized iterations=20"],
}


# Phase 14: FedML's split-learning family (cells 32-34), each path with the
# four kernels' launches counted (each must read 0: none is on these paths),
# within PHASE14_BUDGET_S, on cuDNN's deterministic algorithms. Cuts of
# scale, each beside its constant:
PHASE14_BUDGET_S = 45.0
# (a) cell 32, FedGKT through main_fedgkt on the CIFAR-10 surrogate (5,000
# rows over 8 hetero clients): every client capped at GKT_CAP rows (the
# JAX main's --client_sample_cap for quick runs; the test set then 512
# rows), GKT_ROUNDS of the main's 10 rounds, and a 1 + 1 resumed run
GKT_CLIENTS, GKT_CAP, GKT_ROUNDS, GKT_SERVER_LAYERS = 8, 256, 2, (5, 6, 6)
GKT_FLAGS = ["--dataset", "cifar10", "--partition_method", "hetero",
             "--client_num_in_total", str(GKT_CLIENTS), "--client_num_per_round",
             str(GKT_CLIENTS), "--client_sample_cap", str(GKT_CAP), "--batch_size", "64",
             "--epochs", "1", "--epochs_server", "2", "--temperature", "3.0", "--alpha", "1.0",
             "--client_blocks", "1", "--server_blocks", *map(str, GKT_SERVER_LAYERS),
             "--seed", str(SEED)]
# (b) cell 33, SplitNN through main_split_nn at width 16 on the CIFAR-10
# surrogate over 4 clients, SPLIT_CYCLES relay cycles (the JAX main's 5
# cut), at SPLIT_LR: the mains' default lr 0.03 under the reference's
# momentum 0.9 reaches a NaN loss in the second cycle on this surrogate, in
# the JAX main as in the port's (CPU runs of both mains)
SPLIT_CLIENTS, SPLIT_CYCLES, SPLIT_LR = 4, 2, 0.01
# (c) cell 34, vertical FL through main_vfl (the surrogates: lending club's
# 18 + 18 columns, NUS-WIDE's 634 + 500 + 500), and one NeuralVFLAPI epoch
# at VFL_ROWS rows of NUS-WIDE's three-party widths (a third of its 161,789
# training images; 392 MB of float32 features on the card)
VFL_ROWS, VFL_DIMS = 60_000, (634, 500, 500)
PHASE14_CUTS = {
    "fedgkt": [f"client_sample_cap={GKT_CAP}", "test rows=512",
               f"comm_round={GKT_ROUNDS} (of 10)"],
    "split_nn": [f"comm_round={SPLIT_CYCLES} (of 5)", f"lr={SPLIT_LR} (the main's 0.03 "
                 "diverges on the surrogate)"],
    "vfl": ["surrogate data (no NUS-WIDE or lending club files)",
            f"timed epoch on {VFL_ROWS} of 161,789 rows"],
    "launcher": ["comm_round=1", "fedgkt client_sample_cap=64, server_blocks 1 1 1",
                 "vfl epochs=1"],
}


# Phase 15: FedNAS and FedSeg (cells 35-36), each path with the four
# kernels' launches counted (each must read 0), within PHASE15_BUDGET_S, on
# cuDNN's deterministic algorithms. Cuts of scale, each beside its constant:
PHASE15_BUDGET_S = 60.0
# (a) cell 35, FedNAS at the DARTS paper's CIFAR-10 search widths on the
# CIFAR-10 surrogate (5,000 rows over 4 homo clients): every client capped
# at NAS_CAP rows (the test set then 256 rows), NAS_ROUNDS rounds, plus a
# 1 + 1 resumed run. bench.py's fednas rung caps at 256: at 256 phase 15
# took 113.2 s of its 60 (a round 9.0-15.1 s, the search step host-bound
# at 51,282 launches; H100 80GB HBM3, 700 W), so the cap is 128, one step
# of batch 64 a client a round
NAS_CLIENTS, NAS_CAP, NAS_ROUNDS = 4, 128, 2
NAS_WIDTHS = {"channels": 16, "layers": 8, "steps": 4, "multiplier": 4}
NAS_CFG = {"batch_size": 64, "epochs": 1, "lr": 0.025, "momentum": 0.9, "wd": 3e-4}
# (b) cell 36, FedSeg on the pascal_voc surrogate (40 + 10 images; no VOC
# files in the repository): SEG_ROUNDS rounds, plus a 1 + 1 resumed run
SEG_CLIENTS, SEG_ROUNDS, SEG_SIDE, SEG_WIDTH, SEG_BATCH, SEG_LR = 4, 2, 64, 32, 8, 0.007
SEG_RUNG = (128, 64)  # the compute-bound rung: image side, width
PHASE15_CUTS = {
    "fednas": [f"samples a client <= {NAS_CAP} (bench.py's rung: 256)", "test rows=256",
               f"comm_round={NAS_ROUNDS}", "unrolled and gdas: one step each"],
    "fedseg": ["surrogate data (no Pascal VOC files)", f"comm_round={SEG_ROUNDS}",
               "the 128 px rung: two rounds a dtype"],
    "launcher": ["comm_round=1", "fednas batch_size=640 (one step a client)"],
}


# Phase 16: the silo-grouped round and FedAvg over MQTT (cells 37-38), each
# path with the four kernels' launches counted (each must read 0), within
# PHASE16_BUDGET_S, on cuDNN's deterministic algorithms. Cuts of scale, each
# beside its constant:
PHASE16_BUDGET_S = 60.0
# (a) cell 37: the cross-silo config's E = 20 to 1, and every silo capped at
# SILO_CAP rows (10 steps of batch 64), SILO_ROUNDS rounds a path (of 100)
SILO_CAP, SILO_ROUNDS, SILO_THRESHOLDS = 640, 2, (32, 64)
# The silo round against the engine round after each round, leaf by leaf:
# ||silo - engine|| / max(||engine - the round's start||, LEAF_FLOOR *
# sqrt(leaf size)), the share of the leaf's update on which the two paths
# differ, the update floored at an RMS of LEAF_FLOOR a value; and pooled,
# over every leaf at once (dominated by the leaves of most update). The CPU
# tests hold the two to the JAX package's elementwise contract (rtol 1e-4,
# atol 1e-5) at a small width. At the cross-silo width on the card rounding
# alone parts them further: at the initial weights a step's gradient through
# 56 train-mode BatchNorms is a small difference of large sums, so any other
# order of the sums moves a conv or BatchNorm leaf's update by percents, and
# steps grow it. The rounding witness, the silo round on cuDNN's fastest
# algorithms against the deterministic one, reads what rounding alone gives
# (an H100 80GB HBM3 at 700 W, two runs, PERF.md): per leaf at most
# 0.17-0.20 after round 0 and 0.50-0.59 after round 1, where the silo round
# against the engine round reads 0.22 and 0.77. LEAF_TOL[0] lies between
# those and a leaf one side left unchanged (1); after round 1 rounding comes
# near 1, and LEAF_TOL[1] only tells it from a leaf's update of the wrong
# sign or scale (2 and more). POOLED_TOL is about 8x both pooled readings
# after round 1 (the gap's 2.6e-4, the witness's 2.4e-4); one silo of ten
# left out of the aggregate reads about 0.1 there.
LEAF_FLOOR, LEAF_TOL, POOLED_TOL = 1e-6, (0.5, 1.5), 2e-3
# (b) cell 38: FEMNIST's 3400 clients to MQTT_CLIENTS (the workers sample
# MQTT_WORKERS of them a round), MQTT_ROUNDS rounds
MQTT_CLIENTS, MQTT_WORKERS, MQTT_ROUNDS = 10, 2, 2
PHASE16_CUTS = {
    "silo_grouped": ["epochs=1 (of 20)", f"samples a silo <= {SILO_CAP}",
                     f"comm_round={SILO_ROUNDS} (of 100)"],
    "mqtt_fedavg": [f"client_num_in_total={MQTT_CLIENTS} (of 3400)",
                    f"comm_round={MQTT_ROUNDS}"],
}


class Disagreement(RuntimeError):
    """The kernel's result is not its plain version's."""


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_kernels(report: str) -> dict:
    """{mangled kernel name: {"registers", "spill_bytes"}} from the
    ``nvcc -Xptxas -v`` report; spill bytes are stores plus loads."""
    import re

    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {"registers": 0, "spill_bytes": 0})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if cur is not None and m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if cur is not None and m:
            cur["registers"] = int(m.group(1))
    return out


def flash_label(mangled: str):
    """(``flash_bwd_dq_kernel<float32, 64>``, 64) for a flash-attention
    instantiation's mangled name, else None."""
    import re

    m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I(f|13__nv_bfloat16)Li(\d+)E",
                  mangled)
    if m is None:
        return None
    dtype = "float32" if m.group(2) == "f" else "bfloat16"
    return f"{m.group(1)}<{dtype}, {m.group(3)}>", int(m.group(3))


#: the fused epoch's tensor-core kernels (csrc/fused_sgd.cu)
CONV2_KERNELS = ("conv2_fwd_kernel", "conv2_wgrad_kernel", "conv2_dgrad_kernel")


def conv2_label(mangled: str):
    """``conv2_wgrad_kernel<bfloat16>`` for a conv2 tensor-core
    instantiation's mangled name, else None."""
    import re

    m = re.search(r"\d(conv2_(?:fwd|wgrad|dgrad)_kernel)I(f|13__nv_bfloat16)E", mangled)
    if m is None:
        return None
    return f"{m.group(1)}<{'float32' if m.group(2) == 'f' else 'bfloat16'}>"


def check_spills(kernels: dict) -> list:
    """One line per flash or conv2 tensor-core instantiation of a
    ``ptxas_kernels`` report: its registers and bytes of spill. Raises
    RuntimeError on a spill in any conv2 kernel or in a flash kernel with
    D <= 64; a flash spill at D = 128 is only marked."""
    lines, spills = [], []
    for name, x in sorted(kernels.items()):
        flash, conv2 = flash_label(name), conv2_label(name)
        if flash is None and conv2 is None:
            continue
        label = conv2 or flash[0]
        mark = " (SPILL)" if x["spill_bytes"] else ""
        lines.append(f"{label}: {x['registers']} registers, {x['spill_bytes']} bytes of "
                     f"spill{mark}")
        if x["spill_bytes"] and (conv2 or flash[1] <= 64):
            spills.append(f"{label} spills {x['spill_bytes']} bytes")
    if spills:
        raise RuntimeError("; ".join(spills))
    return lines


def device_events(fn) -> list:
    """The profiler's events of the kernels that ``fn()`` runs on the card
    (after one untraced call; a trace with no device event at all is
    retried)."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        if events:
            break
    return events


def device_kernels(fn) -> list:
    """The names of the kernels that ``fn()`` runs on the card."""
    return [e.name for e in device_events(fn)]


def check_one_launch(device) -> list:
    """The forward on the model's split q, k, v views runs exactly one
    kernel on the card, its own, and no layout copy (torch.profiler).
    Returns the device events' names."""
    import torch

    from fedml_tpu_torch.ops import attention as A

    q, k, v = qkv_views(*attention_inputs(ATTN_SHAPES["a"], torch.float32, device)[:3])
    names = device_kernels(lambda: A.flash_fwd(q, k, v, True))
    if len(names) != 1 or "flash_fwd_kernel" not in names[0]:
        raise RuntimeError(f"flash_fwd on split views ran {names} on the card, not one "
                           f"flash_fwd_kernel")
    return names


def backward_kernels_ok(names: list, delta_names: list) -> bool:
    """``names`` (a backward's kernels) are the delta op's kernels
    ``delta_names``, one flash_bwd_dq_kernel and one flash_bwd_dkv_kernel,
    in any order, and nothing else: no layout copy."""
    flash = sorted("dkv" if "flash_bwd_dkv_kernel" in n else "dq"
                   for n in names if "flash_bwd_" in n)
    rest = sorted(n for n in names if "flash_bwd_" not in n)
    return flash == ["dkv", "dq"] and rest == sorted(delta_names)


def check_backward_launches(device) -> list:
    """``flash_bwd`` on the model's split q, k, v views (dO contiguous)
    runs the delta op's kernels, one dQ and one dK/dV kernel on the card,
    and no layout copy of q, k, v or dO (torch.profiler). Returns the
    device events' names."""
    import torch

    from fedml_tpu_torch.ops import attention as A

    q, k, v, do = attention_inputs(ATTN_SHAPES["a"], torch.float32, device)
    views = qkv_views(q, k, v)
    o, lse = A.flash_fwd(*views, True)
    delta_names = device_kernels(lambda: A.attention_delta(o, do))
    names = device_kernels(lambda: A.flash_bwd(*views, o, lse, do, True))
    if not backward_kernels_ok(names, delta_names):
        raise RuntimeError(f"flash_bwd on split views ran {names} on the card, not the delta "
                           f"op's {delta_names} and one kernel each of dQ and dK/dV")
    return names


def cuda_ms(fn, warmup=2, reps=7) -> float:
    """Median milliseconds of ``fn()`` between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_inputs(device, clients, samples, side, classes, seed):
    """Seeded data, dropout seeds and flax-shaped weights (numpy), on
    ``device``."""
    import numpy as np
    import torch

    from fedml_tpu_torch.utils.convert import flax_to_torch

    rng = np.random.RandomState(seed)
    x = rng.rand(clients, samples, side, side, 1).astype(np.float32)
    y = rng.randint(0, classes, size=(clients, samples)).astype(np.int32)
    seeds = rng.randint(0, 2 ** 31 - 1, size=clients).astype(np.int32)
    pooled = ((side - 4) // 2) ** 2 * 64
    shapes = {"conv2d_1": (3, 3, 1, 32), "conv2d_2": (3, 3, 32, 64),
              "linear_1": (pooled, 128), "linear_2": (128, classes)}
    tree = {}
    for name, shape in shapes.items():
        fan_in = int(np.prod(shape[:-1]))
        tree[name] = {
            "kernel": (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32),
            "bias": (0.01 * rng.normal(size=shape[-1])).astype(np.float32)}
    params = flax_to_torch({"params": tree}, device=device)
    return (params, torch.from_numpy(x).to(device), torch.from_numpy(y).to(device),
            torch.from_numpy(seeds).to(device))


def agreement(kernel: dict, plain: dict, global_params: dict, tol: dict) -> dict:
    """Readings of the kernel's stacked per-client params against the plain
    version's: the largest elementwise difference, the count of elements
    outside (rtol, atol), and per leaf the median and the largest over
    clients of ||kernel - plain|| / ||plain - global||."""
    import torch

    out = {"max_abs": 0.0, "outside": 0, "count": 0, "rel_median": {}, "rel_max": {}}
    for key, p in plain.items():
        k = kernel[key]
        if not torch.isfinite(k).all():
            raise Disagreement(f"kernel output {key} is not finite")
        diff = (k - p).abs()
        out["max_abs"] = max(out["max_abs"], diff.max().item())
        out["outside"] += int((diff > tol["atol"] + tol["rtol"] * p.abs()).sum())
        out["count"] += diff.numel()
        clients = p.shape[0]
        update = (p - global_params[key][None]).reshape(clients, -1).norm(dim=1)
        rel = (k - p).reshape(clients, -1).norm(dim=1) / update.clamp_min(1e-30)
        out["rel_median"][key] = rel.median().item()
        out["rel_max"][key] = rel.max().item()
    return out


def check_agreement(tag: str, kernel: dict, plain: dict, global_params: dict,
                    tol: dict, outliers: float) -> dict:
    """``agreement`` held to ``tol``, with at most a fraction ``outliers`` of
    the elements outside (rtol, atol); raises Disagreement."""
    r = agreement(kernel, plain, global_params, tol)
    median, worst = max(r["rel_median"].values()), max(r["rel_max"].values())
    if r["outside"] > outliers * r["count"]:
        raise Disagreement(f"{tag}: {r['outside']} of {r['count']} elements outside "
                           f"rtol {tol['rtol']} atol {tol['atol']}")
    if r["max_abs"] > tol["max_abs"]:
        raise Disagreement(f"{tag}: an element differs by {r['max_abs']:.3e}")
    if median > tol["rel_median"] or worst > tol["rel_max"]:
        raise Disagreement(f"{tag}: difference over update per leaf: median "
                           f"{r['rel_median']}, max {r['rel_max']}")
    return r


def check_controls(tag: str, plain: dict, global_params: dict, tol: dict,
                   outliers: float) -> int:
    """``check_agreement`` must reject a kernel that skips the update, skips
    one leaf's update, or skips one leaf's update in one client. Returns the
    number of faults it rejected; raises if it passes one."""
    faults = {"no update": {k: global_params[k][None].expand_as(p)
                            for k, p in plain.items()}}
    for key, p in plain.items():
        faults[f"no {key} update"] = {**plain, key: global_params[key][None].expand_as(p)}
        one = p.clone()
        one[-1] = global_params[key]
        faults[f"no {key} update in the last client"] = {**plain, key: one}
    for name, fault in faults.items():
        try:
            check_agreement(tag, fault, plain, global_params, tol, outliers)
        except Disagreement:
            continue
        raise RuntimeError(f"{tag}: the agreement check passed a kernel with {name}")
    return len(faults)


def compare_fused_epoch(dtype_name, device, clients, samples, side, classes, seed,
                        outliers, strict=True, tol=None):
    """fused_epoch (kernel) vs fused_epoch_reference (plain) on the same
    inputs, held to ``tol`` (``TOL[dtype_name]`` unless given). Raises on a
    mismatch unless ``strict`` is false. Returns (inputs, spec, readings,
    (kernel params, plain params))."""
    import torch

    from fedml_tpu_torch.ops import fused_sgd

    cdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    spec = fused_sgd.FusedEpochSpec(height=side, width=side, n_classes=classes,
                                    samples=samples, batch=BATCH, lr=0.1,
                                    grad_clip=1.0, drop1=0.25, drop2=0.5,
                                    compute_dtype=cdtype)
    inputs = make_inputs(device, clients, samples, side, classes, seed)
    kp, km = fused_sgd.fused_epoch(spec, *inputs)
    pp, pm = fused_sgd.fused_epoch_reference(spec, *inputs)
    torch.cuda.synchronize()
    tag = (f"fused_epoch[{dtype_name}] {clients}x{samples} {side}x{side} C={classes} "
           f"seed {seed}")
    tol = tol or TOL[dtype_name]
    r = agreement(kp, pp, inputs[0], tol)
    r["loss_rel"] = ((km["loss_sum"] - pm["loss_sum"]).abs()
                     / pm["loss_sum"].abs()).max().item()
    r["correct_diff"] = (km["correct"] - pm["correct"]).abs().max().item()
    log(f"{tag}: params max_abs {r['max_abs']:.3e}, {r['outside']}/{r['count']} outside "
        f"rtol {tol['rtol']} atol {tol['atol']} (allowed fraction {outliers}); "
        f"difference over update per leaf: median "
        f"{max(r['rel_median'].values()):.3e}, max {max(r['rel_max'].values()):.3e}; "
        f"loss_sum max_rel {r['loss_rel']:.3e}; correct max diff {r['correct_diff']:.0f}")
    if strict:
        check_agreement(tag, kp, pp, inputs[0], tol, outliers)
        if (r["loss_rel"] > tol["loss"] or r["correct_diff"] > 2
                or not torch.equal(km["total"], pm["total"])):
            raise Disagreement(f"{tag}: metrics differ: kernel {km} plain {pm}")
        controls = check_controls(tag, pp, inputs[0], tol, outliers)
        log(f"{tag}: the check rejected all {controls} faulted copies of the result")
    return inputs, spec, r, (kp, pp)


def check_determinism(dtype_name: str, spec, inputs) -> None:
    """Two epochs on the same inputs give the same bits (no atomics, split
    sums reduced in a fixed order); a copy with one bit flipped must fail."""
    from fedml_tpu_torch.ops import fused_sgd

    (p1, m1), (p2, m2) = [fused_sgd.fused_epoch(spec, *inputs) for _ in range(2)]
    tag = f"fused_epoch[{dtype_name}] flagship, two runs"
    for key in p1:
        bitwise(f"{tag}: {key}", p2[key], p1[key])
    for key in m1:
        bitwise(f"{tag}: metric {key}", m2[key], m1[key])
    key = "conv2d_2.weight"
    faulted = bits(p2[key]).clone()
    faulted.view(-1)[0] ^= 1
    must_fail(f"{tag}: {key} one bit off",
              lambda: bitwise("control", faulted.view(p2[key].dtype), p1[key]))
    log(f"{tag}: bitwise equal; a copy one bit off fails")


def check_fused_epoch(dtype_name: str, device) -> dict:
    """The kernel against its plain version at a small shape (every element
    within tolerance) and at the flagship shape, where two runs must agree
    bit for bit; times both at the flagship shape and computes the bound."""
    from fedml_tpu_torch.ops import fused_sgd

    tol = TOL[dtype_name]
    compare_fused_epoch(dtype_name, device, 3, 40, 12, 5, SEED, 0.0)
    inputs, spec, readings, _ = compare_fused_epoch(
        dtype_name, device, CLIENTS, SAMPLES, SIDE, CLASSES, SEED, tol["outliers"])
    check_determinism(dtype_name, spec, inputs)
    return time_fused_epoch(dtype_name, "flagship", spec, inputs, readings["max_abs"])


def time_fused_epoch(dtype_name: str, tag: str, spec, inputs, max_abs: float) -> dict:
    """The kernel's and the plain version's time on ``inputs`` (CUDA
    events) and the bound: the larger of the epoch's FLOP over the card's
    peak for the type and its bytes (inputs read once, outputs written
    once) over the memory rate."""
    from fedml_tpu_torch.ops import fused_sgd

    ms = cuda_ms(lambda: fused_sgd.fused_epoch(spec, *inputs))
    plain_ms = cuda_ms(lambda: fused_sgd.fused_epoch_reference(spec, *inputs),
                       warmup=1, reps=5)
    params, x, y, seeds = inputs
    clients = x.shape[0]
    flops = spec.flops_per_round(clients)
    nbytes = (x.numel() * 4 + y.numel() * 4 + seeds.numel() * 4   # inputs read once
              + spec.NP * 4                                        # global weights
              + clients * spec.NP * 4 + clients * 3 * 4)           # outputs
    flop_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    byte_ms = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(flop_ms, byte_ms)
    bound_by = "operations" if flop_ms >= byte_ms else "bytes"
    log(f"fused_epoch[{dtype_name}] {tag} ({clients} x {spec.n}): kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB -> bound "
        f"{bound_ms:.3f} ms ({bound_by}), {bound_ms / ms:.1%} of it; "
        f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s achieved")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def close(tag: str, got, want, rtol: float, atol: float) -> dict:
    """Every element of ``got`` within (rtol, atol) of ``want``; raises
    Disagreement. Returns the largest difference and the largest share of
    the allowance used."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise Disagreement(f"{tag}: shape {tuple(got.shape)} vs {tuple(want.shape)}, "
                           f"finite {bool(torch.isfinite(got).all())}")
    diff = (got - want).abs()
    share = (diff / (atol + rtol * want.abs())).max().item()
    if share > 1.0:
        raise Disagreement(f"{tag}: {int((diff > atol + rtol * want.abs()).sum())} elements "
                           f"outside rtol {rtol} atol {atol}, max diff {diff.max().item():.3e}")
    return {"max_abs": diff.max().item(), "share": share}


def bits(t):
    """The bits of a float32 or bf16 tensor, as a contiguous int tensor."""
    import torch

    return t.contiguous().view({4: torch.int32, 2: torch.int16}[t.element_size()])


def bitwise(tag: str, got, want) -> None:
    """``got`` holds the same bits as ``want``; raises Disagreement."""
    if (got.shape != want.shape or got.dtype != want.dtype
            or not bits(got).equal(bits(want))):
        raise Disagreement(f"{tag}: not bitwise equal")


def qkv_views(q, k, v):
    """q, k, v as views of one [B, T, 3H, D] tensor, cut as
    models/transformer.py cuts the qkv projection."""
    import torch

    return torch.cat((q, k, v), dim=2).split(q.shape[2], dim=2)


def must_fail(tag: str, fn) -> None:
    try:
        fn()
    except Disagreement:
        return
    raise RuntimeError(f"{tag}: the check passed a faulted result")


def attention_inputs(shape, dtype, device, seed=SEED):
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(device, dtype)
            for _ in range(4)]


def attention_work(shape, causal, elem):
    """(flops of the forward, dq, dkv; bytes of each): 2 products for the
    forward, 3 for dq, 4 for dkv, each 2 D FLOP per live (query, key) pair;
    each input read once, each output written once."""
    b, t, h, d = shape
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    x, row = b * t * h * d * elem, b * h * t * 4
    flops = {n: products * pairs * 2 * d
             for n, products in (("flash_fwd", 2), ("flash_bwd_dq", 3), ("flash_bwd_dkv", 4))}
    nbytes = {"flash_fwd": 3 * x + x + row,
              "flash_bwd_dq": 4 * x + 2 * row + x,
              "flash_bwd_dkv": 4 * x + 2 * row + 2 * x}
    return flops, nbytes


def check_attention_case(dtype_name, device, key, causal):
    """The three flash kernels against their plain versions at shape ``key``;
    faulted results must fail. Returns the inputs and {kernel: max_abs}."""
    import torch

    from fedml_tpu_torch.ops import attention as A

    dt = getattr(torch, dtype_name)
    shape = ATTN_SHAPES[key]
    q, k, v, do = attention_inputs(shape, dt, device)
    tol = ATTN_TOL[dtype_name]
    tag = f"flash[{dtype_name}] {key}={shape} causal={causal}"
    o, lse = A.flash_fwd(q, k, v, causal)
    po, plse = A.flash_fwd_reference(q, k, v, causal)
    views = qkv_views(q, k, v)
    so, slse = A.flash_fwd(*views, causal)
    delta = A.attention_delta(o, do)
    dq = A.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = A.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    split_grads = (A.flash_bwd_dq(*views, do, lse, delta, causal),
                   *A.flash_bwd_dkv(*views, do, lse, delta, causal))
    pdq = A.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    pdk, pdv = A.flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    r = {"o": close(f"{tag} O", o, po, *tol["o"]),
         "lse": close(f"{tag} lse", lse, plse, *tol["lse"]),
         "dq": close(f"{tag} dQ", dq, pdq, *tol["grad"]),
         "dk": close(f"{tag} dK", dk, pdk, *tol["grad"]),
         "dv": close(f"{tag} dV", dv, pdv, *tol["grad"])}
    bitwise(f"{tag} O from split views", so, o)
    bitwise(f"{tag} lse from split views", slse, lse)
    for name, got, want in zip(("dQ", "dK", "dV"), split_grads, (dq, dk, dv)):
        bitwise(f"{tag} {name} from split views", got, want)
    # faulted results: O without the causal mask, dQ with the last key tile
    # dropped (its keys zeroed: their ds . k terms vanish, nothing else
    # moves), dK and dV swapped
    if causal:
        must_fail(f"{tag} O without the causal mask", lambda: close(
            "control", A.flash_fwd_reference(q, k, v, False)[0], po, *tol["o"]))
    t0 = (shape[1] - 1) // 64 * 64
    k_cut = k.clone()
    k_cut[:, t0:] = 0
    must_fail(f"{tag} dQ with one key tile dropped", lambda: close(
        "control", A.flash_bwd_dq_reference(q, k_cut, v, do, lse, delta, causal), pdq,
        *tol["grad"]))
    must_fail(f"{tag} dK and dV swapped", lambda: (
        close("control", pdv, pdk, *tol["grad"]), close("control", pdk, pdv, *tol["grad"])))
    one_bit = bits(so).clone()
    one_bit.view(-1)[-1] ^= 1
    must_fail(f"{tag} O from split views one bit off",
              lambda: bitwise("control", one_bit.view(o.dtype), o))
    one_bit_dk = bits(split_grads[1]).clone()
    one_bit_dk.view(-1)[0] ^= 1
    must_fail(f"{tag} dK from split views one bit off",
              lambda: bitwise("control", one_bit_dk.view(dk.dtype), dk))
    log(f"{tag}: max diff O {r['o']['max_abs']:.3e}, lse {r['lse']['max_abs']:.3e}, "
        f"dQ {r['dq']['max_abs']:.3e}, dK {r['dk']['max_abs']:.3e}, "
        f"dV {r['dv']['max_abs']:.3e}; largest share of the allowance "
        f"{max(x['share'] for x in r.values()):.3f} (O {r['o']['share']:.3f}, lse "
        f"{r['lse']['share']:.3f}, dQ {r['dq']['share']:.3f}, dK {r['dk']['share']:.3f}, "
        f"dV {r['dv']['share']:.3f}); split views bitwise equal, forward and backward; "
        f"controls rejected")
    errs = {"flash_fwd": max(r["o"]["max_abs"], r["lse"]["max_abs"]),
            "flash_bwd_dq": r["dq"]["max_abs"],
            "flash_bwd_dkv": max(r["dk"]["max_abs"], r["dv"]["max_abs"])}
    return (q, k, v, do, o, lse, delta), errs


def time_attention(dtype_name, key, inputs) -> dict:
    """Each flash kernel's time, its plain version's and its bound at shape
    ``key`` (causal), and PyTorch's SDPA forward and backward on the same
    inputs."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops import attention as A

    q, k, v, do, o, lse, delta = inputs
    shape = ATTN_SHAPES[key]
    runs = {
        "flash_fwd": (lambda: A.flash_fwd(q, k, v, True),
                      lambda: A.flash_fwd_reference(q, k, v, True)),
        "flash_bwd_dq": (lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, True),
                         lambda: A.flash_bwd_dq_reference(q, k, v, do, lse, delta, True)),
        "flash_bwd_dkv": (lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta, True),
                          lambda: A.flash_bwd_dkv_reference(q, k, v, do, lse, delta, True)),
    }
    flops, nbytes = attention_work(shape, True, q.element_size())
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    doh = do.transpose(1, 2)
    lib = {"flash_fwd": cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True))}
    oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    lib["flash_bwd_dq"] = lib["flash_bwd_dkv"] = cuda_ms(
        lambda: torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True))
    out = {}
    for name, (kernel, plain) in runs.items():
        flop_ms = flops[name] / PEAK_FLOPS[dtype_name] * 1e3
        byte_ms = nbytes[name] / PEAK_BYTES * 1e3
        out[name] = {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
                     "bound_ms": max(flop_ms, byte_ms),
                     "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
                     "library_ms": lib[name]}
        x = out[name]
        log(f"{name}[{dtype_name}] {key}={shape} causal: kernel {x['ms']:.4f} ms, plain "
            f"{x['plain_ms']:.4f} ms, bound {x['bound_ms']:.4f} ms ({x['bound_by']}; "
            f"{flops[name] / 1e9:.3f} GFLOP, {nbytes[name] / 1e6:.2f} MB), "
            f"SDPA {x['library_ms']:.4f} ms; "
            f"{flops[name] / (x['ms'] * 1e-3) / 1e12:.2f} TFLOP/s achieved")
    return out


def check_attention(dtype_name, device) -> dict:
    """All shapes, causal and not; times at shapes (a) and (c). Returns
    {kernel: {max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms}}
    at shape (c)."""
    errs, inputs = {}, {}
    for key in ATTN_SHAPES:
        for causal in (False, True):
            x, e = check_attention_case(dtype_name, device, key, causal)
            if causal:
                inputs[key] = x
            errs = {n: max(errs.get(n, 0.0), e[n]) for n in e}
    time_attention(dtype_name, "a", inputs["a"])
    numbers = time_attention(dtype_name, "c", inputs["c"])
    return {n: {"max_abs_err": errs[n], **numbers[n]} for n in numbers}


def capped(ds, cap, test_cap=256):
    import dataclasses

    import numpy as np

    from fedml_tpu_torch.data.packing import PackedClients

    return dataclasses.replace(
        ds,
        train=PackedClients(np.ascontiguousarray(ds.train.x[:, :cap]),
                            np.ascontiguousarray(ds.train.y[:, :cap]),
                            np.minimum(ds.train.counts, cap)),
        test_global=(ds.test_global[0][:test_cap], ds.test_global[1][:test_cap]))


def femnist_cfg(clients: int, rounds: int, per_round: int):
    """The FEMNIST flagship's configuration: CNN_DropOut, batch 20, lr 0.1,
    clip 1.0, E = 1."""
    from fedml_tpu_torch import FedConfig

    return FedConfig(dataset="femnist", model="cnn", client_num_in_total=clients,
                     client_num_per_round=per_round, batch_size=BATCH, lr=0.1,
                     grad_clip=1.0, epochs=1, comm_round=rounds, seed=SEED)


def cnn_trainer(ds):
    from fedml_tpu_torch import ClassificationTrainer, create_model

    return ClassificationTrainer(create_model("cnn", output_dim=ds.class_num))


def femnist_api(ds, fused: bool, aggregator: str = "fedavg", **overrides):
    """FedAvgAPI on the card for the FEMNIST flagship (``overrides`` replace
    FedConfig fields)."""
    from fedml_tpu_torch import FedAvgAPI

    cfg = femnist_cfg(FEMNIST_CLIENTS, ROUNDS, 10).replace(fused_kernel=fused, **overrides)
    return FedAvgAPI(ds, cfg, cnn_trainer(ds), aggregator_name=aggregator, device="cuda")


def check_trained(tag: str, api, hist, must_fall: bool = True) -> list:
    """Finite globals and finite training losses that fell (unless
    ``must_fall`` is off); returns the losses."""
    import math

    import torch

    for name, t in api.global_variables.items():
        if not torch.isfinite(t).all():
            raise RuntimeError(f"{tag}: global {name} is not finite")
    losses = [h["loss_sum"] / h["total"] for h in hist]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"{tag}: training loss is not finite: {losses}")
    if must_fall and not losses[-1] < losses[0]:
        raise RuntimeError(f"{tag}: training loss did not fall: {losses}")
    return losses


def run_main_path(ds, fused: bool, aggregator: str = "fedavg", tag=None, **overrides):
    tag = tag or ("fused" if fused else "engine")
    api = femnist_api(ds, fused, aggregator, **overrides)
    hist = api.train()
    losses = check_trained(tag, api, hist)
    for h, loss in zip(hist, losses):
        log(f"  {tag} round {h['round']}: {h['round_time'] * 1e3:.2f} ms, train loss "
            f"{loss:.4f}, Test/Acc {h['Test/Acc']:.4f}")
    return hist


def load_nwp():
    from fedml_tpu_torch import load_dataset

    t0 = time.perf_counter()
    ds = load_dataset("stackoverflow_nwp", client_num_in_total=NWP_CLIENTS, seed=SEED)
    log(f"stackoverflow_nwp surrogate: {NWP_CLIENTS} clients, {ds.train.total_samples} "
        f"train windows of {ds.train.x.shape[2]} tokens, padded width {ds.train.n_max}, "
        f"built in {time.perf_counter() - t0:.1f} s")
    return ds


class TimedAggregator:
    """An aggregator whose every call is bracketed by CUDA events."""

    def __init__(self, inner):
        self.inner = inner
        self.events = []

    def init_state(self, global_variables):
        return self.inner.init_state(global_variables)

    def __call__(self, *args):
        import torch

        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = self.inner(*args)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self) -> list:
        import torch

        torch.cuda.synchronize()
        return [start.elapsed_time(end) for start, end in self.events]


def timed_aggregation(api, trainer, cfg) -> TimedAggregator:
    """Rebuild ``api``'s round around a TimedAggregator of its aggregator."""
    from fedml_tpu_torch.algorithms.engine import build_round_fn

    timed = TimedAggregator(api.aggregator)
    api.round_fn = build_round_fn(trainer, cfg, timed, device=api.device,
                                  collect_stats=True)
    return timed


def time_server_step(tag: str, api) -> dict:
    """The FedOpt server step alone on the run's final globals and state,
    with a mean 1e-3 away from the globals: the median of 7 calls between
    CUDA events, the sum of its kernels' device time (torch.profiler), and
    its bound: params, mean and each moment read, params and each moment
    written, over the card's memory rate."""
    import torch

    gv, state = api.global_variables, api.agg_state
    gen = torch.Generator(device=api.device).manual_seed(SEED)
    avg = {k: v + 1e-3 * torch.randn(v.shape, generator=gen, device=api.device)
           for k, v in gv.items()}
    def step():
        return api.aggregator.server_step(gv, avg, state)

    ms = cuda_ms(step)
    kernels = device_events(step)
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    n = sum(t.numel() for t in gv.values())
    moments = sum(1 for name in ("mu", "nu", "trace", "sum") if name in state)
    nbytes = (2 + moments) * 4 * n + (1 + moments) * 4 * n
    bound = nbytes / PEAK_BYTES * 1e3
    log(f"{tag} server step ({n} parameters): {ms:.4f} ms between CUDA events, "
        f"{len(kernels)} kernels busy {busy:.4f} ms (profiler); bound {bound:.4f} ms "
        f"({nbytes / 1e6:.1f} MB over {PEAK_BYTES / 1e12:.2f} TB/s)")
    return {"ms": ms, "busy_ms": busy, "bound_ms": bound, "params": n}


def run_nwp_path(ds, aggregator: str = "fedavg", tag: str = "nwp", **overrides) -> list:
    """The StackOverflow NWP surrogate with the transformer LM at full
    width, through FedAvgAPI on the card; with ``fedopt`` the aggregator
    calls are timed and then the server step alone."""
    from fedml_tpu_torch import FedAvgAPI, FedConfig, NWPTrainer, create_model

    cfg = FedConfig(dataset="stackoverflow_nwp", model="transformer_nwp",
                    client_num_in_total=NWP_CLIENTS, client_num_per_round=NWP_PER_ROUND,
                    batch_size=NWP_BATCH, lr=NWP_LR, grad_clip=1.0, epochs=1,
                    comm_round=ROUNDS, seed=SEED).replace(**overrides)
    trainer = NWPTrainer(create_model("transformer_nwp", output_dim=ds.class_num))
    api = FedAvgAPI(ds, cfg, trainer, aggregator_name=aggregator, device="cuda")
    timed = timed_aggregation(api, trainer, cfg) if aggregator == "fedopt" else None
    n_params = sum(t.numel() for t in api.global_variables.values())
    hist = api.train()
    losses = check_trained(tag, api, hist)
    for h, loss in zip(hist, losses):
        test = (f", Test/Acc {h['Test/Acc']:.4f}, Test/Loss {h['Test/Loss']:.4f}"
                if "Test/Acc" in h else "")
        log(f"  {tag} round {h['round']}: {h['round_time'] * 1e3:.2f} ms, train loss "
            f"{loss:.4f}{test}")
    log(f"{tag} path: transformer_nwp {n_params} parameters, median round "
        f"{statistics.median([h['round_time'] * 1e3 for h in hist[1:]]):.2f} ms over rounds "
        f"1-{len(hist) - 1}")
    if timed is not None:
        agg_ms = timed.ms()
        log(f"{tag} aggregator call (weighted mean of {NWP_PER_ROUND} clients + server "
            f"step), device ms a round: {[round(t, 4) for t in agg_ms]}, median of rounds "
            f"1-{len(agg_ms) - 1} {statistics.median(agg_ms[1:]):.4f}")
        time_server_step(tag, api)
    return hist


def count_launches(fn):
    """``fn()`` with every kernel's launch count set to 0 just before and
    read just after: (fn's result, {kernel: launches})."""
    from fedml_tpu_torch.ops import attention, fused_sgd

    fused_sgd.launches = 0
    for name in attention.launches:
        attention.launches[name] = 0
    out = fn()
    return out, {"fused_epoch": fused_sgd.launches, **attention.launches}


def with_launches(tag: str, kernels, fn):
    """``fn()`` with the launch counts of ``kernels`` set to 0 just before
    and read just after; raises if one of them launched no time. Returns
    (fn's result, {kernel: launches})."""
    out, counts = count_launches(fn)
    counts = {k: counts[k] for k in kernels}
    missing = [k for k, c in counts.items() if c <= 0]
    if missing:
        raise RuntimeError(f"the {tag} path launched {missing} no time")
    log(f"{tag} path launches: {counts}")
    return out, counts


def max_diff(a: dict, b: dict) -> float:
    return max((a[k] - b[k]).abs().max().item() for k in a)


def check_fused_server_rules(ds, launches: dict) -> None:
    """Phase 4's fused FEMNIST runs; adds each run's launches to
    ``launches``."""
    import math

    from fedml_tpu_torch.experiments import main_fedavg_robust

    # each round of a pair starts both rules from the same globals: chained
    # rounds of the CNN amplify the first round's 1e-10 rounding of
    # g - (g - avg) to ~1e-6 (the plain version on the CPU, 2 rounds)
    for name, limit, overrides in (
            ("fedopt", 1e-6, dict(server_optimizer="sgd", server_lr=1.0)),
            ("fednova", 1e-4, {})):
        base, other = femnist_api(ds, True), femnist_api(ds, True, name, **overrides)
        diffs, n_base, n_other = [], 0, 0
        for r in range(2):
            other.global_variables = {k: v.clone() for k, v in base.global_variables.items()}
            _, n = with_launches(f"fused fedavg, round {r}", ["fused_epoch"],
                                 lambda: base.train_one_round(r))
            n_base += n["fused_epoch"]
            _, n = with_launches(f"fused {name}, round {r}", ["fused_epoch"],
                                 lambda: other.train_one_round(r))
            n_other += n["fused_epoch"]
            diffs.append(max_diff(other.global_variables, base.global_variables))
        log(f"fused {name} {overrides} vs fedavg, 2 rounds, each from the same globals: "
            f"max abs difference {[f'{d:.3e}' for d in diffs]} (limit {limit:.0e})")
        if not max(diffs) < limit:
            raise RuntimeError(f"fused {name} differs from fedavg by {max(diffs):.3e}")
        launches[f"femnist fused fedavg ({name} pair)"] = n_base
        launches[f"femnist fused {name}"] = n_other

    def yogi():
        api = femnist_api(ds, True, "fedopt", server_optimizer="yogi", server_lr=0.01)
        timed = timed_aggregation(api, api.trainer, api.cfg)
        hist = api.train()
        losses = check_trained("fused fedyogi", api, hist)
        log(f"fused fedyogi (server lr 0.01): train loss {[round(v, 4) for v in losses]}, "
            f"median round {statistics.median([h['round_time'] * 1e3 for h in hist[1:]]):.2f} "
            f"ms, aggregator call device ms {[round(t, 4) for t in timed.ms()]}")
        time_server_step("fused fedyogi", api)

    _, n = with_launches("fused fedyogi", ["fused_epoch"], yogi)
    launches["femnist fused fedyogi"] = n["fused_epoch"]

    # the robust CLI: 30 clients give a padded width of 360, a multiple of
    # the batch, as the fused kernel needs
    with tempfile.TemporaryDirectory() as run_dir:
        argv = ["--dataset", "femnist", "--model", "cnn", "--client_num_in_total", "30",
                "--client_num_per_round", "10", "--batch_size", str(BATCH), "--lr", "0.1",
                "--comm_round", "3", "--frequency_of_the_test", "3", "--fused_kernel", "1",
                "--attacker_num", "1", "--seed", str(SEED), "--device", "cuda",
                "--run_dir", run_dir]
        hist, n = with_launches("fused robust CLI", ["fused_epoch"],
                                lambda: main_fedavg_robust.main(argv))
    values = [h["loss_sum"] for h in hist] + [hist[-1]["Test/Loss"]]
    if not all(math.isfinite(v) for v in values):
        raise RuntimeError(f"robust CLI: non-finite losses {values}")
    log(f"fused robust CLI: train loss {[round(h['loss_sum'] / h['total'], 4) for h in hist]}, "
        f"Test/Loss {hist[-1]['Test/Loss']:.4f}, MainTask/Acc "
        f"{hist[-1]['MainTask/Acc']:.4f}, Backdoor/SuccessRate "
        f"{hist[-1]['Backdoor/SuccessRate']:.4f}")
    launches["femnist fused robust CLI"] = n["fused_epoch"]


def zoo_path(tag: str, launches: dict, fn):
    """Phase 5: ``fn()`` with the four kernels' launches counted (each must
    read 0: no kernel is on these paths); the counts go to
    ``launches[tag]``."""
    out, counts = count_launches(fn)
    if any(counts.values()):
        raise RuntimeError(f"the {tag} path launched a kernel: {counts}")
    launches[tag] = counts
    log(f"{tag} path launches: {counts}")
    return out


def check_zoo_run(tag: str, api, hist, profile: bool = True, must_fall: bool = True) -> None:
    """A phase 5 run: finite globals and a falling loss (see
    ``check_trained``); with ``profile`` one more round under
    torch.profiler; logs the path's numbers."""
    from fedml_tpu_torch.experiments import profile_zoo

    check_trained(tag, api, hist, must_fall)
    if profile:
        # the device's activity alone: the same readings, without the host
        # events whose reading took minutes at a ResNet-56 round's 293,000
        # launches (on an H100 80GB HBM3 at 700 W)
        prof = profile_zoo.profiled_round(api, len(hist), host_events=False)
        log(profile_zoo.summary(tag, hist, prof))
    else:
        log(f"{tag}: rounds {[round(h['round_time'] * 1e3, 2) for h in hist]} ms, train "
            f"loss {[round(v, 4) for v in profile_zoo.losses(hist)]}")


def gradient_norms(api) -> tuple:
    """(global, fc.weight's) gradient norm of one train-mode step at the
    globals, on client 0's first batch."""
    import torch
    import torch.nn.functional as F

    v = {k: t.detach().clone().requires_grad_(True) for k, t in api.global_variables.items()}
    b = api.cfg.batch_size
    x = torch.from_numpy(api.dataset.train.x[0, :b]).to(api.device)
    y = torch.from_numpy(api.dataset.train.y[0, :b]).to(api.device)
    out, _ = api.trainer.apply(v, x, None, True)
    grads = dict(zip(v, torch.autograd.grad(F.cross_entropy(out.float(), y.long()),
                                            list(v.values()))))
    total = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values())).item()
    return total, grads["fc.weight"].norm().item()


def check_running_statistics(api) -> None:
    """Every global BatchNorm statistic moved from its init (mean 0, var 1)
    and is finite; an eval-mode call returns no new state; the evaluation
    reads the running statistics (resetting them changes Test/Loss)."""
    import torch

    from fedml_tpu_torch.utils.pytree import split_variables

    stats = split_variables(api.global_variables)[1]
    if not stats:
        raise RuntimeError("cross-silo: the globals hold no BatchNorm statistics")
    for k, v in stats.items():
        init = 0.0 if k.endswith(".mean") else 1.0
        if not torch.isfinite(v).all() or torch.equal(v, torch.full_like(v, init)):
            raise RuntimeError(f"cross-silo: statistic {k} is not finite or never moved")
    x = torch.from_numpy(api.dataset.test_global[0][:8]).to(api.device)
    _, state = api.trainer.apply(api.global_variables, x, None, False)
    if state:
        raise RuntimeError("cross-silo: an eval-mode call returned new state")
    kept = api.test_global(0)["Test/Loss"]
    saved = api.global_variables
    api.global_variables = {k: (torch.zeros_like(v) if k.endswith(".mean") else
                                torch.ones_like(v) if k.endswith(".var") else v)
                            for k, v in saved.items()}
    reset = api.test_global(0)["Test/Loss"]
    api.global_variables = saved
    if reset == kept:
        raise RuntimeError("cross-silo: the evaluation does not read the running statistics")
    log(f"cross-silo running statistics: {len(stats)} leaves moved and finite; Test/Loss "
        f"{kept:.4f} with them, {reset:.4f} with mean 0 / var 1")


def check_fedavgm_statistics(launches: dict) -> None:
    """FedAvgM (server SGD lr 1, momentum 0.9) beside FedAvg on cross-silo
    ResNet-56, 2 rounds, each from the same globals, cuDNN deterministic:
    the BatchNorm statistics must equal FedAvg's weighted mean within 1e-6."""
    import torch

    from fedml_tpu_torch.experiments import profile_zoo
    from fedml_tpu_torch.utils.pytree import split_variables

    epochs = ["--epochs", str(XS_PAIR_EPOCHS)]
    base = profile_zoo.make_api("cross_silo", *epochs)
    other = profile_zoo.make_api("cross_silo", *epochs, "--server_optimizer", "sgd",
                                 "--server_lr", "1.0", "--server_momentum", "0.9",
                                 aggregator="fedopt")
    ds = base.dataset
    log(f"cifar10 surrogate: 10 silos (hetero, alpha 0.5), {ds.train.total_samples} train "
        f"rows, padded width {ds.train.n_max}")
    torch.backends.cudnn.deterministic = True
    try:
        stat_diffs, param_diffs, hist, times = [], [], [], []
        for r in range(2):
            other.global_variables = {k: v.clone() for k, v in base.global_variables.items()}
            t0 = time.perf_counter()
            zoo_path(f"cross-silo fedavg (fedavgm pair), round {r}", launches,
                     lambda: base.train_one_round(r))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            hist.append(zoo_path(f"cross-silo fedavgm, round {r}", launches,
                                 lambda: other.train_one_round(r)))
            (bp, bs), (op, os_) = (split_variables(base.global_variables),
                                   split_variables(other.global_variables))
            stat_diffs.append(max_diff(os_, bs))
            param_diffs.append(max_diff(op, bp))
    finally:
        torch.backends.cudnn.deterministic = False
    losses = [h["loss_sum"] / h["total"] for h in hist]
    log(f"cross-silo fedavgm vs fedavg ({XS_PAIR_EPOCHS} epoch), 2 rounds each from the "
        f"same globals: statistics max abs difference {[f'{d:.3e}' for d in stat_diffs]} "
        f"(limit 1e-6), parameters {[f'{d:.3e}' for d in param_diffs]}; fedavgm train loss "
        f"{[round(v, 4) for v in losses]}")
    if not max(stat_diffs) < 1e-6:
        raise RuntimeError(f"fedavgm's BatchNorm statistics differ from fedavg's mean by "
                           f"{max(stat_diffs):.3e}")
    if not all(torch.isfinite(v).all() for v in other.global_variables.values()):
        raise RuntimeError("cross-silo fedavgm: non-finite globals")
    log(f"cross-silo fedavg 1-epoch rounds (cuDNN deterministic): "
        f"{[round(t, 2) for t in times]} ms")


def check_round_budget(tag: str, hist) -> None:
    """Reports each round over XS_ROUND_S; the cut stays XS_EPOCHS."""
    slow = [round(h["round_time"], 1) for h in hist if h["round_time"] > XS_ROUND_S]
    if slow:
        log(f"WARNING {tag}: rounds of {slow} s exceed the {XS_ROUND_S:.0f} s budget that "
            f"E = {XS_EPOCHS} was chosen for (a slower host; the work is the same)")


def run_zoo_paths() -> dict:
    """Phase 5: FedML's benchmark rows beyond FEMNIST on the card. Returns
    {path: {kernel: launches}}."""
    import torch

    from fedml_tpu_torch.experiments import main_fedavg, profile_zoo

    launches: dict = {}
    check_fedavgm_statistics(launches)
    epochs = ["--epochs", str(XS_EPOCHS)]
    api = profile_zoo.make_api("cross_silo", *epochs)
    tag = f"cross-silo resnet56 (E={XS_EPOCHS}, cut from 20; 2 rounds, cut from 100)"
    hist = zoo_path("cross-silo resnet56", launches, api.train)
    check_zoo_run(tag, api, hist, profile=False)
    check_round_budget(tag, hist)
    check_running_statistics(api)
    bf16 = profile_zoo.make_api("cross_silo", "--epochs", str(XS_BF16_EPOCHS), "--dtype",
                                "bfloat16")
    bf16.global_variables = {k: v.clone() for k, v in api.global_variables.items()}
    bhist = zoo_path("cross-silo resnet56 bf16", launches, bf16.train)
    check_zoo_run(f"cross-silo resnet56 bf16 (E={XS_BF16_EPOCHS}, 2 rounds from the float32 "
                  "globals)", bf16, bhist, profile=False)
    # reading a 10-silo round's 293,000 device events took 75-90 s on an
    # H100 80GB HBM3 at 700 W
    one = profile_zoo.make_api("cross_silo", "--epochs", "1", "--client_num_per_round",
                               str(XS_PROFILED_SILOS))
    one.global_variables = api.global_variables
    zoo_path("cross-silo resnet56, profiled round", launches,
             lambda: log(profile_zoo.summary(f"{tag}; a 1-epoch round of "
                                             f"{XS_PROFILED_SILOS} silo profiled", hist,
                                             profile_zoo.profiled_round(
                                                 one, 2, host_events=False))))
    del api, bf16, one

    t0 = time.perf_counter()
    api = profile_zoo.make_api("fed_cifar100")
    log(f"fed_cifar100: 500 clients x {api.dataset.train.n_max} rows, set up in "
        f"{time.perf_counter() - t0:.1f} s")
    init = {k: v.clone() for k, v in api.global_variables.items()}
    total, fc = gradient_norms(api)
    log(f"fed_cifar100 resnet18_gn at init: a step's global gradient norm {total:.1f}, "
        f"fc.weight's {fc:.3f}, against the clip at {api.cfg.grad_clip}")
    hist = zoo_path("fed_cifar100 resnet18_gn", launches, api.train)
    # This config barely learns in a run, for a cause the JAX package
    # shares (the same model and clip): on 24x24 inputs the last stage is
    # 1x1, so each GroupNorm of 2 channels normalises two numbers and its
    # gradient grows as 1/|a - b|. The global norm logged above is orders
    # of magnitude over the clip at 1.0 (the reference trainer's), which
    # leaves fc and the rest a sliver of their gradient, and the loss only
    # wanders (ROADMAP, Queue 3): over 3 rounds it rose in 2 of 8 runs on
    # the H100, so this path is held to every global having moved.
    still = [k for k, v in api.global_variables.items() if torch.equal(v, init[k])]
    if still:
        raise RuntimeError(f"fed_cifar100: globals that training never moved: {still}")
    zoo_path("fed_cifar100 resnet18_gn, profiled round", launches,
             lambda: check_zoo_run("fed_cifar100 resnet18_gn (3 rounds, cut from 4000)",
                                   api, hist, must_fall=False))
    del api

    for path, rounds in (("shakespeare", 3), ("fed_shakespeare", 2)):
        api = profile_zoo.make_api(path)
        hist = zoo_path(f"{path} rnn", launches, api.train)
        zoo_path(f"{path} rnn, profiled round", launches,
                 lambda: check_zoo_run(f"{path} rnn ({rounds} rounds, cut from 1200)", api,
                                       hist))

    with tempfile.TemporaryDirectory() as run_dir:
        hist = zoo_path("cli defaults (mnist lr)", launches,
                        lambda: main_fedavg.main(["--run_dir", run_dir]))
    losses = [h["loss_sum"] / h["total"] for h in hist]
    if not losses[-1] < losses[0] or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"cli defaults: training loss did not fall: {losses}")
    log(f"cli defaults (mnist lr, {len(hist)} rounds): median round "
        f"{statistics.median([h['round_time'] * 1e3 for h in hist]):.2f} ms, train loss "
        f"{[round(v, 4) for v in losses]}, final Test/Acc {hist[-1]['Test/Acc']:.4f}")
    return launches


def same_bits(tag: str, got, want) -> None:
    """Every tensor of the tree ``got`` holds the bits of ``want``'s (any
    dtype); raises Disagreement."""
    import torch

    from fedml_tpu_torch.utils.pytree import tree_leaves

    a, b = tree_leaves(got), tree_leaves(want)
    if [p for p, _ in a] != [p for p, _ in b]:
        raise Disagreement(f"{tag}: the trees hold other leaves")
    for (path, x), (_, y) in zip(a, b):
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)):
            raise Disagreement(f"{tag}: {path} not bitwise equal")


def round_numbers(tracer) -> dict:
    """The drive's per-round timings from the tracer's spans, over the
    rounds 1..R-2 (round 0 and the last evaluate): the median round span;
    the median and the mean spacing between the starts of consecutive
    rounds (the wall a round costs in steady state at any depth: a
    pipelined round span ends before the card finishes it; where the
    record flush every few rounds waits for the card, the median spacing
    misses that wait and the mean holds it); and each phase's median
    per-round total (a round may hold two ``metrics_fetch`` spans: the
    round's own and its record flush)."""
    rounds = sorted({s["round"] for s in tracer.find_spans("round")})
    steady = rounds[1:-1] or rounds
    starts = {s["round"]: s["t0"] for s in tracer.find_spans("round")}
    totals: dict = {}
    for s in tracer.spans:
        if s["name"] in DRIVE_SPANS and s["round"] in steady:
            per_round = totals.setdefault(s["name"], dict.fromkeys(steady, 0.0))
            per_round[s["round"]] += s["dur_s"] * 1e3
    gaps = [(starts[r + 1] - starts[r]) * 1e3 for r in steady if r + 1 in starts]
    return {"median_round_ms": statistics.median(
                s["dur_s"] * 1e3 for s in tracer.find_spans("round") if s["round"] in steady),
            "round_spacing_ms": statistics.median(gaps) if gaps else None,
            "mean_spacing_ms": statistics.mean(gaps) if gaps else None,
            "phase_ms": {k: statistics.median(v.values()) for k, v in totals.items()},
            "rounds": [steady[0], steady[-1]]}


def drive(tag: str, api, **train_kw) -> tuple:
    """``api.train`` under a fresh Tracer; logs ``round_numbers``. Returns
    (history, tracer, numbers)."""
    from fedml_tpu_torch.telemetry import Tracer

    tracer = Tracer()
    hist = api.train(tracer=tracer, **train_kw)
    numbers = round_numbers(tracer)
    log(f"{tag}: rounds {numbers['rounds'][0]}-{numbers['rounds'][1]}: median round "
        f"{numbers['median_round_ms']:.3f} ms, round spacing median "
        f"{numbers['round_spacing_ms'] or float('nan'):.3f} ms, mean "
        f"{numbers['mean_spacing_ms'] or float('nan'):.3f} ms, per-round phase medians ms "
        f"{ {k: round(v, 3) for k, v in numbers['phase_ms'].items()} }")
    return hist, tracer, numbers


def flip_staged_byte(api, round_idx: int) -> None:
    """A faulted control: ``api.stage_fn`` flips one byte (bits 16-23 of
    the first sample's largest pixel) of round ``round_idx``'s cohort after
    its copy to the card."""
    import torch

    stage = api.stage_fn

    def flipped(r, **kw):
        staged = stage(r, **kw)
        if r == round_idx:
            staged.ready.synchronize()
            flat = staged.x.reshape(-1)
            i = int(flat[: staged.x[0, 0].numel()].abs().argmax())
            flat.view(torch.uint8)[4 * i + 2: 4 * i + 3].bitwise_xor_(0xFF)
            torch.cuda.synchronize()
        return staged

    api.stage_fn = flipped


def check_fused_drives(ds, launches: dict) -> dict:
    """Phase 6, FEMNIST through the fused kernel: 5 rounds at depth 0 and
    at PIPE_DEPTH, 3 rounds + checkpoint + a new api restored for 2 more,
    all bit for bit equal; a depth-PIPE_DEPTH run with one staged byte
    flipped must differ; then the timing pair, TIME_ROUNDS rounds at each
    depth (also bit for bit equal). Each run launches the kernel once a
    round. Returns the timing pair's numbers."""

    def run(tag, depth, rounds=ROUNDS, run_rounds=None, **train_kw):
        api = femnist_api(ds, True, pipeline_depth=depth, comm_round=rounds,
                          frequency_of_the_test=rounds)
        (hist, _, numbers), n = with_launches(tag, ["fused_epoch"],
                                              lambda: drive(tag, api, **train_kw))
        launches[tag] = n["fused_epoch"]
        if n["fused_epoch"] != (run_rounds or rounds):
            raise RuntimeError(f"{tag}: {n['fused_epoch']} fused launches in "
                               f"{run_rounds or rounds} rounds")
        check_trained(tag, api, hist)
        return api, numbers

    eager, _ = run("femnist fused depth 0", 0)
    piped, _ = run(f"femnist fused depth {PIPE_DEPTH}", PIPE_DEPTH)
    same_bits("fused depth 2 vs depth 0 globals", piped.global_variables,
              eager.global_variables)
    same_bits("fused depth 2 vs depth 0 state", piped.agg_state, eager.agg_state)
    with tempfile.TemporaryDirectory() as ckpt:
        run("femnist fused resumed, first 3 rounds", PIPE_DEPTH, 3, ckpt_dir=ckpt,
            ckpt_every=100)
        resumed, _ = run("femnist fused resumed, rounds 3-4", PIPE_DEPTH, run_rounds=2,
                         ckpt_dir=ckpt, ckpt_every=100)
    same_bits("fused resumed vs 5 straight rounds", resumed.global_variables,
              eager.global_variables)
    faulted = femnist_api(ds, True, pipeline_depth=PIPE_DEPTH, frequency_of_the_test=ROUNDS)
    flip_staged_byte(faulted, 2)
    faulted.train()
    must_fail("fused depth 2 with a flipped staged byte",
              lambda: same_bits("faulted", faulted.global_variables, eager.global_variables))
    apis, numbers = {}, {}
    for depth in (0, PIPE_DEPTH):
        apis[depth], numbers[f"depth {depth}"] = run(
            f"femnist fused depth {depth}, {TIME_ROUNDS} rounds", depth, TIME_ROUNDS)
    same_bits(f"fused depth 2 vs depth 0, {TIME_ROUNDS} rounds",
              apis[PIPE_DEPTH].global_variables, apis[0].global_variables)
    log(f"fused drives: depth {PIPE_DEPTH} ({ROUNDS} and {TIME_ROUNDS} rounds) and 3 + 2 "
        f"resumed rounds bit for bit depth 0's; a run with one staged byte flipped differs")
    return numbers


def chaos_seed(rounds: int, clients: int, round_idx: int, **rates) -> int:
    """The first chaos seed whose plan NaN-faults a client in ``round_idx``
    (plans are pure in their seed: the choice is the same on every run)."""
    from fedml_tpu_torch.robustness.chaos import FaultPlan

    return next(s for s in range(1000)
                if FaultPlan(seed=s, **rates).events(round_idx, clients).nan_mask.any())


def check_chaos_cli(run_dir: str) -> None:
    """Phase 6, FEMNIST on the engine path through the CLI with chaos and
    the guard: quarantined_count >= 1 in wandb-summary.json (the last
    round's), guard_verdict events in TRACE.jsonl, finite globals in the
    final checkpoint."""
    import math
    import os

    import torch

    from fedml_tpu_torch.experiments import main_fedavg

    rounds = 3
    seed = chaos_seed(rounds, 10, rounds - 1, drop_rate=0.3, nan_rate=0.3)
    run, ckpt = os.path.join(run_dir, "chaos"), os.path.join(run_dir, "chaos_ckpt")
    argv = ["--dataset", "femnist", "--model", "cnn", "--client_num_in_total",
            str(FEMNIST_CLIENTS), "--client_num_per_round", "10", "--batch_size", str(BATCH),
            "--lr", "0.1", "--comm_round", str(rounds), "--frequency_of_the_test",
            str(rounds), "--seed", str(SEED), "--chaos", "1", "--chaos_seed", str(seed),
            "--chaos_drop_rate", "0.3", "--chaos_nan_rate", "0.3", "--guard", "1",
            "--run_dir", run, "--ckpt_dir", ckpt, "--device", "cuda"]
    hist, n = count_launches(lambda: main_fedavg.main(argv))
    if any(n.values()):
        raise RuntimeError(f"the engine chaos CLI launched a kernel: {n}")
    with open(os.path.join(run, "wandb-summary.json")) as f:
        summary = json.load(f)
    with open(os.path.join(run, "TRACE.jsonl")) as f:
        events = [json.loads(line) for line in f]
    verdicts = [e for e in events if e.get("kind") == "guard_verdict"]
    tree = torch.load(os.path.join(ckpt, f"ckpt_{rounds}", "tree.pt"), weights_only=True)
    finite = all(torch.isfinite(v).all() for v in tree["variables"].values())
    if not (summary.get("quarantined_count", 0) >= 1 and len(verdicts) >= rounds and finite
            and math.isfinite(hist[-1]["Test/Loss"])):
        raise RuntimeError(f"engine chaos CLI: summary {summary}, {len(verdicts)} verdicts, "
                           f"finite globals {finite}")
    log(f"engine chaos CLI (chaos seed {seed}, drop 0.3, NaN 0.3, guard on, depth "
        f"{PIPE_DEPTH}): quarantined {[h['quarantined_count'] for h in hist]}, dropped "
        f"{[h['chaos_dropped'] for h in hist]}, guard verdicts "
        f"{[e['ok'] for e in verdicts]}, median round "
        f"{statistics.median(h['round_time'] * 1e3 for h in hist):.2f} ms, "
        f"Test/Acc {hist[-1]['Test/Acc']:.4f}; globals finite")


def check_nwp_drives(nwp, launches: dict) -> dict:
    """Phase 6, NWP at full width for 3 rounds at depth 0 and at
    PIPE_DEPTH, round 1 NaN-faulting one client (out-of-range token ids):
    the client is quarantined with no device assert, the loss falls and
    the three flash kernels launch."""
    from fedml_tpu_torch import FedAvgAPI, FedConfig, NWPTrainer, create_model
    from fedml_tpu_torch.ops import attention
    from fedml_tpu_torch.robustness.chaos import FaultPlan

    rounds = 3
    rates = dict(nan_rate=0.0, overrides={1: {"nan_rate": 0.02}})
    seed = chaos_seed(rounds, NWP_PER_ROUND, 1, **rates)
    numbers = {}
    for depth in (0, PIPE_DEPTH):
        cfg = FedConfig(dataset="stackoverflow_nwp", model="transformer_nwp",
                        client_num_in_total=NWP_CLIENTS, client_num_per_round=NWP_PER_ROUND,
                        batch_size=NWP_BATCH, lr=NWP_LR, grad_clip=1.0, epochs=1,
                        comm_round=rounds, frequency_of_the_test=rounds, seed=SEED,
                        pipeline_depth=depth)
        trainer = NWPTrainer(create_model("transformer_nwp", output_dim=nwp.class_num))
        api = FedAvgAPI(nwp, cfg, trainer, device="cuda")
        tag = f"nwp depth {depth}"
        (hist, _, numbers[f"depth {depth}"]), launches[tag] = with_launches(
            tag, list(attention.launches),
            lambda: drive(tag, api, chaos=FaultPlan(seed=seed, **rates)))
        losses = check_trained(tag, api, hist)
        quarantined = [h["quarantined_count"] for h in hist]
        if quarantined[1] < 1 or quarantined[0] or quarantined[2]:
            raise RuntimeError(f"{tag}: quarantined {quarantined}, wanted round 1 only")
        log(f"{tag}: chaos seed {seed}, quarantined {quarantined}, participated "
            f"{[h['participated_count'] for h in hist]}, train loss "
            f"{[round(v, 4) for v in losses]}")
    return numbers


def run_drives(ds, nwp, fused_launches: dict, flash_launches: dict) -> dict:
    """Phase 6: the JAX CLI's drive on the card (the pipelined loop, resume,
    chaos with the guard, the tracer's spans). Returns the depth-0 and
    depth-PIPE_DEPTH numbers of the fused and NWP paths."""
    numbers = {"femnist fused": check_fused_drives(ds, fused_launches)}
    with tempfile.TemporaryDirectory() as run_dir:
        check_chaos_cli(run_dir)
    numbers["nwp"] = check_nwp_drives(nwp, flash_launches)
    return numbers


# ------------------------------------------------------------------ phase 7


def build_femnist_store(root: str, clients: int, seed: int = SEED,
                        chunk: int = STORE_CHUNK) -> dict:
    """The FEMNIST surrogate (``sources.femnist_surrogate_clients``: the
    draws of ``load_dataset("femnist")``) written chunk by chunk of clients:
    the train split into the shard store ``root/train``, the test split into
    ``root/test``, the flat test set into ``root/test_global.npz``. The
    padded federation is never built in RAM. Runs in a process of its own,
    whose peak RSS (sampled, not the ``ru_maxrss`` a child inherits:
    ``scale_rss.PeakRss``) is the build's. Returns the build's numbers."""
    import os

    import numpy as np

    from fedml_tpu_torch.data import sources
    from fedml_tpu_torch.data.packed_store import ShardWriter
    from fedml_tpu_torch.data.packing import pack_client_lists
    from fedml_tpu_torch.experiments.scale_rss import PeakRss

    with PeakRss() as rss:
        t0 = time.perf_counter()
        widths = {"train": sources.FEMNIST_MAX_SAMPLES,
                  "test": sources.FEMNIST_MAX_SAMPLES // 9}
        writers = {split: ShardWriter(os.path.join(root, split)) for split in widths}
        pending = {split: ([], []) for split in widths}
        largest = dict.fromkeys(widths, 0)
        test_global = ([], [])

        def flush():
            for split, (xs, ys) in pending.items():
                if xs:
                    packed = pack_client_lists(xs, ys, n_max=widths[split])
                    writers[split].append(packed.x, packed.y, packed.counts)
                    largest[split] = max(largest[split], int(packed.counts.max()))
                    xs.clear()
                    ys.clear()

        for i, (x, y, tx, ty) in enumerate(sources.femnist_surrogate_clients(clients, seed)):
            for (xs, ys), a, b in ((pending["train"], x, y), (pending["test"], tx, ty),
                                   (test_global, tx, ty)):
                xs.append(a)
                ys.append(b)
            if (i + 1) % chunk == 0:
                flush()
        flush()
        for w in writers.values():
            w.close()
        np.savez(os.path.join(root, "test_global.npz"), x=np.concatenate(test_global[0]),
                 y=np.concatenate(test_global[1]))
        seconds = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, files in os.walk(root) for f in files)
    return {"seconds": seconds, "bytes": nbytes, "largest": largest, "widths": widths,
            "peak_rss_mb": rss.peak_mb, "start_rss_mb": rss.start_mb}


def check_store_widths(built: dict) -> None:
    """The store's padded widths are its largest clients' sizes, as
    ``load_dataset``'s in-RAM packing pads them (at 3400 clients the train
    split reaches the surrogate's clip, 480)."""
    if built["largest"] != built["widths"]:
        raise RuntimeError(f"the store's padded widths {built['widths']} are not its largest "
                           f"clients' {built['largest']}: in-RAM packing would differ")


def flagship_store(root: str, clients: int):
    """Phase 7, step 1: check the disk, build the store in a spawned process
    and open it as a FederatedDataset whose train and test splits are
    MmapPackedStores. ``train_global`` is empty: no path of the port reads
    it, and the flat copy would take 1.2 GB. Returns (dataset, build
    numbers)."""
    import multiprocessing
    import os
    import shutil

    import numpy as np

    from fedml_tpu_torch.data import sources
    from fedml_tpu_torch.data.packed_store import MmapPackedStore
    from fedml_tpu_torch.data.registry import FederatedDataset

    rows = sources.FEMNIST_MAX_SAMPLES + sources.FEMNIST_MAX_SAMPLES // 9
    need = clients * rows * (SIDE * SIDE * 4 + 4)  # float32 x, int32 y
    free = shutil.disk_usage(root).free
    log(f"flagship store: {free / 1e9:.2f} GB free under {root}, the store needs "
        f"{need / 1e9:.2f} GB")
    if free < 1.2 * need:
        raise RuntimeError(f"not enough disk for the {clients}-client store under {root}")
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        built = pool.apply(build_femnist_store, (root, clients))
    check_store_widths(built)
    with np.load(os.path.join(root, "test_global.npz")) as f:
        test_global = (f["x"], f["y"])
    train = MmapPackedStore(os.path.join(root, "train"))
    ds = FederatedDataset(name="femnist", train=train,
                          test=MmapPackedStore(os.path.join(root, "test")),
                          train_global=(np.zeros((0, SIDE, SIDE, 1), np.float32),
                                        np.zeros(0, np.int32)),
                          test_global=test_global, class_num=CLASSES)
    log(f"flagship store: {clients} clients, {train.total_samples} train samples, padded "
        f"width {train.n_max} (test {ds.test.n_max}), {len(test_global[1])} global test "
        f"samples; built in {built['seconds']:.1f} s, {built['bytes'] / 1e9:.3f} GB on disk, "
        f"the build's peak RSS {built['peak_rss_mb']:.1f} MB (from "
        f"{built['start_rss_mb']:.1f} MB before it)")
    return ds, built


def sync_control(device) -> None:
    """A faulted control of the sync check: under the mode, a ``.item()``
    of a tensor on the card must raise."""
    import torch

    try:
        torch.zeros((), device=device).item()
    except RuntimeError:
        return
    raise RuntimeError("the sync check passed a .item() on the card")


def dispatch_without_sync(tag: str, api, round_idx: int, chaos=None) -> dict:
    """Stage round ``round_idx`` of ``api`` and wait for its copies, then
    dispatch it under ``torch.cuda.set_sync_debug_mode("error")``: any
    synchronising call inside the round raises, and so must a ``.item()``
    after it (``sync_control``). Returns its train metrics, which must be
    finite."""
    import torch

    from fedml_tpu_torch.telemetry import NULL_TRACER

    staged = api.stage_fn(round_idx, chaos=chaos)
    # a personalized round's rows, gathered as the drive loops do
    api._gather_personal(staged, NULL_TRACER)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = api._dispatch(staged, 0)
        sync_control(api.device)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    metrics = api._fetch(metrics)
    staged.release()
    if not all(math.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"{tag}: the checked round's metrics are not finite: {metrics}")
    log(f"sync check, {tag}: round {round_idx} dispatched with no host sync; metrics "
        f"{ {k: round(v, 4) for k, v in metrics.items()} }")
    return metrics


def check_flagship_kernel(device) -> dict:
    """Phase 7, step 3: the fused epoch against its plain version at the
    flagship's padded width (CLIENTS x FLAGSHIP_SAMPLES: 24 steps), float32
    within TOL_480 (its faulted copies must fail, and so must a copy of the
    kernel's result with one exponent bit of one element flipped), bfloat16
    read and not held (see TOL_480); each type timed with its bound.
    Returns each type's numbers."""
    import torch

    numbers = {}
    for d in ("float32", "bfloat16"):
        held = d == "float32"
        inputs, spec, readings, (kp, pp) = compare_fused_epoch(
            d, device, CLIENTS, FLAGSHIP_SAMPLES, SIDE, CLASSES, SEED, TOL_480["outliers"],
            strict=held, tol=TOL_480 if held else None)
        if held:
            key = "linear_1.weight"
            faulted = kp[key].clone()
            faulted.view(-1)[:1].view(torch.int32).bitwise_xor_(1 << 30)
            must_fail(f"fused_epoch[{d}] {CLIENTS}x{FLAGSHIP_SAMPLES}: {key} one bit off",
                      lambda: check_agreement("control", {**kp, key: faulted}, pp, inputs[0],
                                              TOL_480, TOL_480["outliers"]))
        numbers[d] = time_fused_epoch(d, f"at {FLAGSHIP_SAMPLES} rows", spec, inputs,
                                      readings["max_abs"])
    return numbers


def run_scale_rss() -> dict:
    """Phase 7, step 6: ``experiments/scale_rss.py`` at SCALE_POINTS (each
    point a process of its own, training on the card); the last point's
    peak RSS must stay within SCALE_RSS_RATIO of the one before."""
    import os

    cmd = [sys.executable, "-m", "fedml_tpu_torch.experiments.scale_rss", "--points",
           ",".join(str(n) for n in SCALE_POINTS)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise RuntimeError(f"scale_rss failed (rc {proc.returncode}):\n{proc.stderr[-4000:]}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    points, summary = lines[:-1], lines[-1]
    for p in points:
        log(f"scale_rss {p['clients']} clients: peak RSS {p['peak_rss_mb']:.1f} MB (from "
            f"{p['start_rss_mb']:.1f} MB at the point's start; ru_maxrss "
            f"{p['ru_maxrss_mb']:.1f} MB), "
            f"{p['rounds_per_sec']:.3f} rounds/s, store {p['store_logical_mb']:.1f} MB "
            f"logical / {p['store_physical_mb']:.2f} MB on disk, on {p['device']}")
    ratio = summary["rss_ratio_last_over_prev"]
    log(f"scale_rss: peak RSS of {points[-1]['clients']} clients over {points[-2]['clients']}: "
        f"{ratio:.4f}")
    if ratio > SCALE_RSS_RATIO:
        raise RuntimeError(f"scale_rss: peak RSS grew {ratio:.3f}x from "
                           f"{points[-2]['clients']} to {points[-1]['clients']} clients")
    return {"points": points, "ratio": ratio}


def run_flagship(nwp, device, fused_launches: dict) -> dict:
    """Phase 7: the FEMNIST flagship at its configured 3400 clients from an
    mmap shard store, fused and engine, at depth PIPE_DEPTH; the kernel at
    the store's padded width; one round each of the fused, the masked
    engine and the NWP path under the sync check; scale_rss. Returns its
    numbers."""
    from fedml_tpu_torch import FedAvgAPI, FedConfig, NWPTrainer, create_model
    from fedml_tpu_torch.robustness.chaos import FaultPlan

    started = time.perf_counter()
    numbers = {}
    flagship = dict(client_num_in_total=FLAGSHIP_CLIENTS, pipeline_depth=PIPE_DEPTH)
    with tempfile.TemporaryDirectory(prefix="femnist_store_") as root:
        ds, numbers["build"] = flagship_store(root, FLAGSHIP_CLIENTS)
        tag = f"flagship {FLAGSHIP_CLIENTS} fused depth {PIPE_DEPTH}"
        api = femnist_api(ds, True, comm_round=FLAGSHIP_ROUNDS,
                          frequency_of_the_test=FLAGSHIP_ROUNDS, **flagship)
        (hist, _, numbers["fused"]), n = with_launches(tag, ["fused_epoch"],
                                                       lambda: drive(tag, api))
        fused_launches[tag] = n["fused_epoch"]
        if n["fused_epoch"] != FLAGSHIP_ROUNDS:
            raise RuntimeError(f"{tag}: {n['fused_epoch']} launches in {FLAGSHIP_ROUNDS} rounds")
        losses = check_trained(tag, api, hist)
        log(f"{tag}: train loss {[round(v, 4) for v in losses]}, Train/Acc "
            f"{hist[-1]['Train/Acc']:.4f}, Test/Acc {hist[-1]['Test/Acc']:.4f}")
        dispatch_without_sync(f"fused {FLAGSHIP_CLIENTS}", api, FLAGSHIP_ROUNDS)
        numbers["kernel"] = check_flagship_kernel(device)

        tag = f"flagship {FLAGSHIP_CLIENTS} engine depth {PIPE_DEPTH}, fast sampling"
        engine = femnist_api(ds, False, comm_round=FLAGSHIP_ENGINE_ROUNDS,
                             frequency_of_the_test=FLAGSHIP_ENGINE_ROUNDS, fast_sampling=True,
                             **flagship)
        (hist, _, numbers["engine"]), n = count_launches(lambda: drive(tag, engine))
        if any(n.values()):
            raise RuntimeError(f"{tag} launched a kernel: {n}")
        losses = check_trained(tag, engine, hist)
        log(f"{tag}: train loss {[round(v, 4) for v in losses]}, Test/Acc "
            f"{hist[-1]['Test/Acc']:.4f}")
        r = FLAGSHIP_ENGINE_ROUNDS
        rates = dict(drop_rate=0.3, nan_rate=0.3)
        metrics = dispatch_without_sync(
            "engine with a participation mask", engine, r,
            chaos=FaultPlan(seed=chaos_seed(r + 1, 10, r, **rates), **rates))
        if metrics["quarantined_count"] < 1:
            raise RuntimeError(f"the sync check's masked round quarantined no client: {metrics}")
        for store in (ds.train, ds.test):
            store.close()

    cfg = FedConfig(dataset="stackoverflow_nwp", model="transformer_nwp",
                    client_num_in_total=NWP_CLIENTS, client_num_per_round=NWP_PER_ROUND,
                    batch_size=NWP_BATCH, lr=NWP_LR, grad_clip=1.0, epochs=1, comm_round=2,
                    seed=SEED)
    nwp_api = FedAvgAPI(nwp, cfg, NWPTrainer(create_model("transformer_nwp",
                                                          output_dim=nwp.class_num)),
                        device="cuda")
    nwp_api.train_one_round(0)
    dispatch_without_sync("nwp at full width", nwp_api, 1)
    numbers["scale"] = run_scale_rss()
    log(f"phase 7: {time.perf_counter() - started:.1f} s")
    return numbers


# ------------------------------------------------------------------ phase 8


def config_paths() -> list:
    """The repo's YAML configs, the launcher examples then the baseline
    twins, each sorted by name."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parent / CONFIG_DIR
    paths = sorted(root.glob("*.yaml")) + sorted((root / "baseline").glob("*.yaml"))
    if len(paths) != 26:
        raise RuntimeError(f"expected the repo's 26 configs under {root}, found {len(paths)}")
    return paths


class CapturedRuns:
    """Wraps ``FedAvgAPI.train`` while in use: each call's API is kept, and
    its Test/Loss at the globals it starts from is read first."""

    def __enter__(self):
        from fedml_tpu_torch.algorithms import fedavg

        self.apis, self._cls = [], fedavg.FedAvgAPI
        self._train = train = self._cls.train
        runs = self

        def recorded(api, *args, **kwargs):
            api.loss_before = api.test_global(0)["Test/Loss"]
            runs.apis.append(api)
            return train(api, *args, **kwargs)

        self._cls.train = recorded
        return self

    def __exit__(self, *exc):
        self._cls.train = self._train


def expected_model(args: dict) -> str:
    """The class the CLI's dataset-contextual dispatch must build."""
    name = args["model"]
    if name == "cnn":
        name = {"har": "har_cnn", "har_subject": "har_cnn",
                "cifar10": "cnn_cifar"}.get(args["dataset"], "cnn")
    return MODEL_CLASSES[name]


def launch(path, overrides, run_dir: str, profile: bool = False) -> dict:
    """``fed_launch.main`` on the card for one round of the config at
    ``path`` with ``overrides``; checks the dataset, model and trainer the
    launcher built, a finite training loss and finite globals, and prints
    the run's line. ``profile``: one more round under torch.profiler (its
    launches and the device's busy share)."""
    import torch

    from fedml_tpu_torch.experiments import fed_launch, profile_zoo

    overrides = ["comm_round=1", f"run_dir={run_dir}", *overrides]
    argv = ["--config", str(path)] + [a for o in overrides for a in ("--override", o)]
    module, main_argv = fed_launch.resolve(argv)
    args = dict(zip(main_argv[::2], main_argv[1::2]))
    args = {k[2:]: v for k, v in args.items()}
    t0 = time.perf_counter()
    with CapturedRuns() as runs:
        hist, counts = count_launches(lambda: fed_launch.main(argv))
    wall = time.perf_counter() - t0
    (api,) = runs.apis
    tag = f"{path.parent.name + '/' if path.parent.name == 'baseline' else ''}{path.name}"
    trainer = "NWPTrainer" if args["dataset"] in ("fed_shakespeare", "stackoverflow_nwp") \
        else "ClassificationTrainer"
    got = (api.dataset.name, type(api.trainer.module).__name__, type(api.trainer).__name__)
    want = (args["dataset"], expected_model(args), trainer)
    if got != want:
        raise RuntimeError(f"{tag} {overrides}: the launcher built {got}, not {want}")
    loss = check_trained(tag, api, hist, must_fall=False)[-1]
    after = hist[-1]["Test/Loss"]
    if not (math.isfinite(api.loss_before) and math.isfinite(after)):
        raise RuntimeError(f"{tag}: Test/Loss {api.loss_before} -> {after}")
    row = {"config": tag, "overrides": overrides[2:], "dataset": got[0], "model": got[1],
           "trainer": got[2], "backend": api.cfg.backend, "dtype": api.cfg.dtype,
           "round_ms": round(hist[-1]["round_time"] * 1e3, 2), "train_loss": round(loss, 4),
           "test_loss_before": round(api.loss_before, 4), "test_loss_after": round(after, 4),
           "launches": counts, "wall_s": round(wall, 2)}
    if profile:
        prof = profile_zoo.profiled_round(api, 1, host_events=False)
        row.update(profiled_round_ms=round(prof["wall_ms"], 2),
                   device_launches=int(prof["launches"]),
                   busy_share=round(prof["busy_ms"] / prof["wall_ms"], 4))
    del api, runs
    torch.cuda.empty_cache()
    log(f"phase 8 run: {json.dumps(row)}")
    return row


def write_multihost_control(directory: str) -> str:
    """A ``fednas`` config with a ``multihost:`` block (not ported: it must
    raise NotImplementedError naming ROADMAP); returns its path."""
    path = f"{directory}/fednas_multihost.yaml"
    with open(path, "w") as f:
        f.write("algorithm: fednas\nargs:\n  dataset: mnist\nmultihost:\n"
                "  coordinator: \"localhost:1234\"\n  num_processes: 4\n")
    return path


def run_launcher(fused_launches: dict) -> dict:
    """Phase 8: ``fed_launch.main`` over the repo's configs on the card.
    Returns the rows."""
    import torch

    from fedml_tpu_torch.experiments import fed_launch

    started = time.perf_counter()
    rows = []
    paths = config_paths()
    with tempfile.TemporaryDirectory() as run_dir:
        for path in paths:
            if path.name == PRIVACY_CONFIG:
                continue  # phase 9 runs it
            rows.append(launch(path, PHASE8_CUTS.get(path.name, []), run_dir))
            if any(rows[-1]["launches"].values()):
                raise RuntimeError(f"{path.name}: a kernel launched on the engine path: "
                                   f"{rows[-1]['launches']}")
        femnist = next(p for p in paths if p.name == "fedavg_femnist.yaml")
        fused = launch(femnist, PHASE8_CUTS[femnist.name] + ["fused_kernel=1"], run_dir)
        if fused["launches"]["fused_epoch"] < 1:
            raise RuntimeError("the launcher's fused FEMNIST run launched the fused epoch "
                               "no time")
        fused_launches["launcher fedavg_femnist.yaml fused"] = fused["launches"]["fused_epoch"]
        rows.append(fused)
        for name in ("fedavg_femnist.yaml", "fed_cifar100_resnet18_gn.yaml"):
            row = next(r for r in rows if r["config"] == name)
            if row["backend"] != "shard_map":
                raise RuntimeError(f"{name} ran with backend {row['backend']}, not as written")
        control = write_multihost_control(run_dir)
        try:
            fed_launch.main(["--config", control])
        except NotImplementedError as e:
            if "ROADMAP" not in str(e):
                raise RuntimeError(f"the multihost block's error names no ROADMAP: {e}")
            log(f"phase 8 control: fednas with a multihost: block raises "
                f"NotImplementedError ({e})")
        else:
            raise RuntimeError("a multihost: block (fednas) did not raise")
        silo = next(p for p in paths if p.name == "cross_silo_cifar10_resnet56.yaml")
        for overrides, bf16, profile in CROSS_SILO_ROWS:
            for dtype in ("float32", "bfloat16") if bf16 else ("float32",):
                rows.append(launch(silo, ["epochs=1", f"client_num_per_round={XS_SILOS}",
                                          *overrides, f"dtype={dtype}"], run_dir,
                                   profile=profile and dtype == "float32"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - started
    if seconds > PHASE8_BUDGET_S:
        log(f"WARNING phase 8 took {seconds:.1f} s, over its {PHASE8_BUDGET_S:.0f} s budget")
    log(f"phase 8: {len(rows)} launcher runs in {seconds:.1f} s")
    return {"seconds": round(seconds, 1), "runs": len(rows)}


# ------------------------------------------------------------------ phase 9


class TimedRounds:
    """Wraps ``cls.train_one_round`` while in use: each API that runs a
    round is kept (``apis``) and each of its rounds' wall ms recorded
    (``ms``, one list an API). A round returns host floats, so its work on
    the card is done when it returns."""

    def __init__(self, cls):
        self.cls = cls

    def __enter__(self):
        self.apis, self.ms = [], []
        self._round = round_fn = self.cls.train_one_round
        runs = self

        def timed(api, *args, **kwargs):
            if not runs.apis or runs.apis[-1] is not api:
                runs.apis.append(api)
                runs.ms.append([])
            t0 = time.perf_counter()
            out = round_fn(api, *args, **kwargs)
            runs.ms[-1].append((time.perf_counter() - t0) * 1e3)
            return out

        self.cls.train_one_round = timed
        return self

    def __exit__(self, *exc):
        self.cls.train_one_round = self._round


def privacy_main(path, run_dir: str, overrides=(), flags=()):
    """A call of ``main_privacy.main`` with the config at ``path`` resolved
    by the launcher, ``overrides`` (key=value) on top, then ``flags``."""
    from fedml_tpu_torch.experiments import fed_launch, main_privacy

    argv = ["--config", str(path), "--override", f"run_dir={run_dir}"]
    argv += [a for o in overrides for a in ("--override", o)]
    module, main_argv = fed_launch.resolve(argv)
    if module != "fedml_tpu_torch.experiments.main_privacy":
        raise RuntimeError(f"{path.name} resolved to {module}, not main_privacy")
    return lambda: main_privacy.main(main_argv + list(flags))


def run_privacy_main(tag: str, run, api_cls, launches: dict) -> dict:
    """``run()``, a call of ``main_privacy.main`` (through the launcher or
    directly), on the card: its rounds timed, its MI report's seconds read
    and the four kernels' launches counted (each must read 0, see
    ``zoo_path``); every branch must stay finite. Returns the run's API,
    round ms, history and final metrics."""
    import torch

    from fedml_tpu_torch.experiments import main_privacy

    run_mi = main_privacy.run_mi_attacks
    mi_s = []

    def timed_mi(*args, **kwargs):
        t0 = time.perf_counter()
        out = run_mi(*args, **kwargs)
        torch.cuda.synchronize()
        mi_s.append(time.perf_counter() - t0)
        return out

    main_privacy.run_mi_attacks = timed_mi
    t0 = time.perf_counter()
    try:
        with TimedRounds(api_cls) as runs:
            hist, final = zoo_path(tag, launches, run)
    finally:
        main_privacy.run_mi_attacks = run_mi
    wall = time.perf_counter() - t0
    (api,) = runs.apis
    for b, variables in enumerate(api.branches):
        for name, t in variables.items():
            if not torch.isfinite(t).all():
                raise RuntimeError(f"{tag}: branch {b} {name} is not finite")
    if not all(math.isfinite(v) for h in hist for v in h.values()):
        raise RuntimeError(f"{tag}: a metric is not finite: {hist}")
    ms = runs.ms[0]
    branches = {k: round(v, 4) for k, v in final.items() if not k.startswith("MI/")}
    log(f"{tag}: {len(hist)} rounds, median round "
        f"{statistics.median(ms[1:] or ms):.2f} ms over rounds 1-{len(ms) - 1}, first "
        f"{ms[0]:.2f} ms, wall {wall:.1f} s; final {json.dumps(branches)}")
    mi = {k: v for k, v in final.items() if k.startswith("MI/")}
    if mi:
        log(f"{tag}: MI report in {mi_s[0]:.2f} s: {json.dumps(mi)}")
    return {"api": api, "ms": ms, "hist": hist, "final": final,
            "mi_s": mi_s[0] if mi_s else None, "wall_s": wall}


def check_privacy_numerics(api) -> dict:
    """On the card, with ``api`` a trained BranchFedAvgAPI: per-sample
    gradient norms from vmap against a loop of autograd at 16 samples
    (float32, rtol 1e-5); the penultimate gradient's closed form against
    autograd with respect to the head's input; the control, where members
    and non-members are the same tensors, which the NN and loss attacks
    must read at advantage exactly 0; robust accuracy at eps 0 equal to
    the ensemble's plain accuracy; and the peak memory of the MI report's
    per-sample gradients at MI_ROWS members."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.experiments.main_privacy import MI_ROWS
    from fedml_tpu_torch.privacy import adv_attack, mi_attack

    trainer, v, dev = api.trainers[0], api.branches[0], api.device
    xtr, ytr = api.dataset.train_global
    x = torch.from_numpy(xtr[:16]).to(dev)
    y = torch.from_numpy(ytr[:16]).to(dev)
    got = mi_attack.make_per_sample_grad_norm(trainer, v)(x, y)
    want = []
    for i in range(len(y)):
        leaves = {k: t.detach().requires_grad_(True) for k, t in v.items()}
        logits, _ = trainer.apply(leaves, x[i:i + 1])
        grads = torch.autograd.grad(F.cross_entropy(logits, y[i:i + 1].long()),
                                    list(leaves.values()))
        want.append(torch.sqrt(sum((g ** 2).sum() for g in grads)))
    want = torch.stack(want)
    norm_rel = ((got - want).abs() / want.abs()).max().item()
    if not norm_rel <= 1e-5:
        raise Disagreement(f"per-sample gradient norms: vmap vs loop rel {norm_rel:.3e}")
    pg = mi_attack.make_penultimate_grad_fn(trainer, v)(x, y)
    with torch.no_grad():
        _, feats = torch.func.functional_call(trainer.module, v, (x,), {"features": True})
    h = F.relu(feats[-1]).requires_grad_(True)
    logits = F.linear(h, v["linear2_out.weight"], v["linear2_out.bias"])
    (ref,) = torch.autograd.grad(F.cross_entropy(logits, y.long(), reduction="sum"), [h])
    pen_err = (pg - ref).abs().max().item()
    if not torch.allclose(pg, ref, rtol=1e-5, atol=1e-6):
        raise Disagreement(f"penultimate closed form vs autograd: max abs {pen_err:.3e}")

    def predict(inp):
        return torch.log(api.branch_probs(inp).mean(0) + 1e-9)

    xs, ys = x[:16], y
    nn_same = mi_attack.NNAttack(top_k=3).fit(predict, xs, xs).score(predict, xs, xs)
    loss_same = mi_attack.loss_attack(mi_attack.make_per_sample_loss(trainer, v),
                                      (xs, ys), (xs, ys))
    if nn_same["advantage"] != 0.0 or loss_same["advantage"] != 0.0:
        raise RuntimeError(f"the advantage-0 control read NN {nn_same['advantage']}, "
                           f"Loss {loss_same['advantage']}")
    xte, yte = api.dataset.test_global
    xt = torch.from_numpy(xte[:256]).to(dev)
    yt = torch.from_numpy(yte[:256]).to(dev)
    with torch.no_grad():
        plain = float((predict(xt).argmax(-1) == yt).float().mean())
    robust = adv_attack.robust_accuracy(predict, xt, yt, [0.0, 0.1, 0.3], attack="pgd")
    if robust[0.0] != plain:
        raise RuntimeError(f"robust accuracy at eps 0 {robust[0.0]} is not the plain "
                           f"{plain}")
    k = min(len(ytr), len(yte), MI_ROWS)
    xm = torch.from_numpy(xtr[:k]).to(dev)
    ym = torch.from_numpy(ytr[:k]).to(dev)
    gn = mi_attack.make_per_sample_grad_norm(trainer, v)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gn(xm, ym)
    torch.cuda.synchronize()
    gn_ms = (time.perf_counter() - t0) * 1e3
    peak_mib = (torch.cuda.max_memory_allocated() - before) / 2 ** 20
    out = {"grad_norm_rel_err": norm_rel, "penultimate_max_abs": pen_err,
           "control_advantage": [nn_same["advantage"], loss_same["advantage"]],
           "robust_pgd": robust, "plain_acc": plain,
           f"grad_norms_{k}_rows_ms": round(gn_ms, 2),
           f"grad_norms_{k}_rows_peak_mib": round(peak_mib, 1)}
    log(f"phase 9 checks: {json.dumps(out)}")
    return out


def run_privacy(launches: dict) -> dict:
    """Phase 9: the fork's privacy package on the card (see the module
    docstring); ``launches[tag]`` gets each run's four kernel counts.
    Returns the phase's numbers."""
    import pathlib

    import torch

    from fedml_tpu_torch.experiments import fed_launch
    from fedml_tpu_torch.experiments.profile_fused import measure_rounds
    from fedml_tpu_torch.privacy.blockensemble import BlockEnsembleAPI
    from fedml_tpu_torch.privacy.branch_fedavg import BranchFedAvgAPI

    started = time.perf_counter()
    path = pathlib.Path(__file__).resolve().parent / CONFIG_DIR / PRIVACY_CONFIG
    out = {}
    with tempfile.TemporaryDirectory() as run_dir:
        argv = ["--config", str(path), "--override", f"run_dir={run_dir}"]
        argv += [a for o in PRIVACY_CUTS for a in ("--override", o)]
        cell = run_privacy_main("privacy blockensemble", lambda: fed_launch.main(argv),
                                BlockEnsembleAPI, launches)
        hist = cell["hist"]
        loss = [h["Train/Loss"] for h in hist]
        if not loss[-1] < loss[0]:
            raise RuntimeError(f"privacy blockensemble: training loss did not fall: {loss}")
        api = cell["api"]
        log(f"privacy blockensemble: Train/Loss round 0 {loss[0]:.4f}, round "
            f"{len(loss) - 1} {loss[-1]:.4f}")
        prof = measure_rounds(lambda r: api.train_one_round(len(hist) + r), 1,
                              host_events=False)
        out["blockensemble"] = {
            "rounds": len(hist), "median_round_ms": round(statistics.median(cell["ms"][1:]), 2),
            "train_loss": [round(loss[0], 4), round(loss[-1], 4)],
            "final": cell["final"], "mi_s": round(cell["mi_s"], 2),
            "wall_s": round(cell["wall_s"], 1),
            "profiled_round_ms": round(prof["wall_ms"], 2),
            "busy_ms": round(prof["busy_ms"], 2),
            "busy_share": round(prof["busy_ms"] / prof["wall_ms"], 4),
            "device_launches": int(prof["launches"])}
        log(f"privacy blockensemble profiled round: {prof['wall_ms']:.2f} ms, device busy "
            f"{prof['busy_ms']:.2f} ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%), "
            f"{prof['launches']:.0f} launches")
        del api, cell
        short = [f"comm_round={PRIVACY_SHORT_ROUNDS}"]
        three = run_privacy_main(
            "privacy blockensemble 3 paths",
            privacy_main(path, run_dir, short + ["num_paths=3", "feat_lmda=0.5"],
                         ["--no_mi_attack"]), BlockEnsembleAPI, launches)
        out["three_paths"] = {"median_round_ms": round(statistics.median(three["ms"][1:]), 2),
                              "train_loss": [round(h["Train/Loss"], 4)
                                             for h in three["hist"]]}
        bf16 = run_privacy_main(
            "privacy blockensemble bf16",
            privacy_main(path, run_dir, ["comm_round=1", "dtype=bfloat16"],
                         ["--no_mi_attack"]), BlockEnsembleAPI, launches)
        out["bf16_round_ms"] = round(bf16["ms"][0], 2)
        del three, bf16
        for method in ENSEMBLE_METHODS:
            run = run_privacy_main(
                f"privacy {method}",
                privacy_main(path, run_dir, short + [f"ensemble_method={method}"],
                             [] if method == "predavg" else ["--no_mi_attack"]),
                BranchFedAvgAPI, launches)
            out[method] = {"median_round_ms": round(statistics.median(run["ms"][1:]), 2),
                           "ensemble_acc": round(run["final"]["Ensemble/Acc"], 4)}
            if method == "predavg":
                out[method]["mi_s"] = round(run["mi_s"], 2)
                out["checks"] = check_privacy_numerics(run["api"])
            del run
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - started
    if seconds > PHASE9_BUDGET_S:
        log(f"WARNING phase 9 took {seconds:.1f} s, over its {PHASE9_BUDGET_S:.0f} s budget")
    out["seconds"] = round(seconds, 1)
    log(f"phase 9: {seconds:.1f} s")
    return out


def check_residual_identity(tag: str, codec, residual: dict) -> None:
    """decode(payload) + new residual == update + residual, bit for bit on
    the card, for a seeded update beside a run's residual rows."""
    import torch

    gen = torch.Generator(device=next(iter(residual.values())).device).manual_seed(SEED)
    update = {k: 1e-2 * torch.randn(r.shape, generator=gen, device=r.device)
              for k, r in residual.items()}
    payload, new = codec.encode(update, residual)
    decoded = codec.decode(payload, update)
    for k in update:
        same_bits(f"{tag} residual identity {k}", decoded[k] + new[k], update[k] + residual[k])


def median_round_ms(hist, rounds) -> float:
    return statistics.median(h["round_time"] * 1e3 for h in hist if h["round"] in rounds)


def transport_codecs(ds, nwp, launches: dict, flash_launches: dict) -> dict:
    """Phase 10 (a) and (b): the codecs on the flagship engine and on NWP."""
    import torch

    from fedml_tpu_torch.ops import attention

    out = {}
    # codec "none" turns the seam off: no codec, no residual in the state.
    # That its round is the round without the seam is the CPU tests' check
    # against the JAX package; here the run is repeated, which holds the
    # bit-for-bit checks below to cuDNN's deterministic algorithms
    engine = femnist_api(ds, False)
    engine.train()
    off = femnist_api(ds, False, update_codec="none", frequency_of_the_test=CODEC_ROUNDS)
    hist = off.train()
    if off.codec is not None or (isinstance(off.agg_state, dict) and "codec" in off.agg_state):
        raise RuntimeError("codec none: the codec seam is on")
    same_bits("codec none, the engine run repeated", off.global_variables,
              engine.global_variables)
    out["none"] = {"median_round_ms": round(median_round_ms(hist, range(1, CODEC_ROUNDS)),
                                            2)}
    log(f"codec none: the seam off, the engine run repeated bit for bit; "
        f"{json.dumps(out['none'])}")
    for codec in ("int8", "topk"):
        tag = f"femnist {codec}"
        api = femnist_api(ds, False, update_codec=codec, codec_k=TOPK_K,
                          comm_round=CODEC_ROUNDS, frequency_of_the_test=CODEC_ROUNDS)
        hist, counts = count_launches(api.train)
        launches[tag] = counts
        check_trained(tag, api, hist, must_fall=False)
        # the globals' loss on every client's train rows: at 64 entries a
        # leaf top-k moves the model slowly, and the clients' own training
        # loss, from the round's globals, barely moves in 5 rounds
        losses = [h["Train/Loss"] for h in hist if "Train/Loss" in h]  # rounds 0, last
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"{tag}: Train/Loss did not fall: {losses}")
        resid = api.agg_state["codec"]
        if not all(torch.isfinite(r).all() for r in resid.values()):
            raise RuntimeError(f"{tag}: a residual is not finite")
        check_residual_identity(tag, api.codec, resid)
        wire = api.codec.wire_bytes(api.global_variables)
        dense = sum(4 * t.numel() for t in api.global_variables.values())
        out[codec] = {"median_round_ms": round(median_round_ms(hist, range(1, CODEC_ROUNDS)),
                                               2),
                      "train_eval_loss": [round(losses[0], 4), round(losses[-1], 4)],
                      "test_acc": round(hist[-1]["Test/Acc"], 4),
                      "wire_bytes": wire, "dense_bytes": dense}
        log(f"{tag}: {json.dumps(out[codec])}; residual identity bit for bit")
    flash = list(attention.launches)
    _, flash_launches["transport nwp int8"] = with_launches(
        "transport nwp int8", flash,
        lambda: run_nwp_path(nwp, tag="nwp int8", update_codec="int8", comm_round=2))
    return out


def transport_buffered(ds, launches: dict) -> dict:
    """Phase 10 (c): FedBuff on the flagship engine."""
    from fedml_tpu_torch.robustness.chaos import FaultPlan
    from fedml_tpu_torch.telemetry import Tracer

    sync = femnist_api(ds, False, comm_round=3)
    sync.train()
    degenerate = femnist_api(ds, False, comm_round=3, buffer_size=10, staleness_alpha=0.0)
    hist = degenerate.train()
    same_bits("degenerate buffer vs the synchronous round", degenerate.global_variables,
              sync.global_variables)
    if [h["buffer_commits"] for h in hist] != [1, 1, 1]:
        raise RuntimeError(f"degenerate buffer: commits {hist}")
    log("degenerate buffer (10 = cohort, alpha 0): bit for bit the synchronous round, "
        "3 rounds")
    runs = []
    for i in range(2):
        api = femnist_api(ds, False, comm_round=BUFF_ROUNDS, buffer_size=BUFF_SIZE,
                          staleness_alpha=BUFF_ALPHA, frequency_of_the_test=BUFF_ROUNDS)
        tracer = Tracer()
        plan = FaultPlan(seed=SEED, straggler_rate=STRAGGLER_RATE,
                         straggler_rounds=STRAGGLER_ROUNDS)
        hist, counts = count_launches(lambda: api.train(chaos=plan, tracer=tracer))
        runs.append((api, hist, tracer))
    launches["femnist fedbuff"] = counts
    (a, hist, tracer), (b, _, _) = runs
    same_bits("fedbuff straggler run twice", b.global_variables, a.global_variables)
    same_bits("fedbuff straggler run twice, state", b.agg_state, a.agg_state)
    check_trained("femnist fedbuff", a, [h for h in hist if h.get("total")])
    commits = tracer.find_events("buffer_committed")
    stale = [e["staleness_max"] for e in commits]
    if not commits or max(stale) < 1:
        raise RuntimeError(f"fedbuff: no stale commit: {commits}")
    out = {"commits": len(commits),
           "committed_updates": a._buffer_host.committed_updates,
           "staleness_p50": [e["staleness_p50"] for e in commits],
           "staleness_max": stale,
           "median_round_ms": round(median_round_ms(hist, range(1, BUFF_ROUNDS - 1)), 2),
           "admit_ms": round(1e3 * statistics.median(
               s["dur_s"] for s in tracer.find_spans("admit")), 4),
           "commit_ms": round(1e3 * statistics.median(
               s["dur_s"] for s in tracer.find_spans("commit")), 4)}
    log(f"fedbuff (buffer {BUFF_SIZE}, alpha {BUFF_ALPHA}, stragglers {STRAGGLER_RATE} x "
        f"1-{STRAGGLER_ROUNDS}): {json.dumps(out)}; two runs bit for bit")
    return out


def transport_superstep(ds, nwp, device, launches: dict, flash_launches: dict) -> dict:
    """Phase 10 (d): the superstep on the flagship engine and on NWP, its
    sync check, and the device sampler at 3400 clients."""
    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms import sampling
    from fedml_tpu_torch.ops import attention
    from fedml_tpu_torch.telemetry import Tracer

    rounds = SUPERSTEP_ROUNDS + 1  # round 0 evaluates, so it runs eagerly
    kw = dict(comm_round=rounds, fast_sampling=True, update_codec="int8",
              frequency_of_the_test=100)
    eager = femnist_api(ds, False, **kw)
    eager_tracer = Tracer()
    eager_hist = eager.train(tracer=eager_tracer)
    fused = femnist_api(ds, False, rounds_per_dispatch=SUPERSTEP_K, **kw)
    tracer = Tracer()
    hist, counts = count_launches(lambda: fused.train(tracer=tracer))
    launches["femnist superstep"] = counts
    same_bits("superstep vs eager", fused.global_variables, eager.global_variables)
    same_bits("superstep vs eager, state", fused.agg_state, eager.agg_state)
    strip = [{k: v for k, v in h.items() if k != "round_time"} for h in hist]
    if strip != [{k: v for k, v in h.items() if k != "round_time"} for h in eager_hist]:
        raise Disagreement("superstep vs eager: the records differ")
    chunks = tracer.find_events("superstep_committed")
    if [e["rounds"] for e in chunks] != [SUPERSTEP_K] * (SUPERSTEP_ROUNDS // SUPERSTEP_K):
        raise RuntimeError(f"superstep: dispatches {chunks}")
    check_trained("femnist superstep", fused, hist)
    # one more dispatch, of rounds 1-4 from the trained globals, under the
    # sync check
    per_round, _, _ = fused._superstep_inputs(1, SUPERSTEP_K, None)
    fn = fused._superstep_fn(SUPERSTEP_K, False)
    resident = fused._resident_train_arrays()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = fn(fused.global_variables, fused.agg_state, *resident, per_round)[2]
        sync_control(device)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not torch.isfinite(metrics["loss_sum"]).all():
        raise RuntimeError("superstep sync check: metrics not finite")
    out = {"dispatches": len(chunks), "rounds_in_dispatches": SUPERSTEP_ROUNDS,
           "dispatch_spans": [len(tracer.find_spans("dispatch")),
                              len(eager_tracer.find_spans("dispatch"))],
           "round_ms": [round(h["round_time"] * 1e3, 2) for h in hist[1:]],
           "eager_round_ms": [round(h["round_time"] * 1e3, 2) for h in eager_hist[1:]]}
    log(f"superstep K={SUPERSTEP_K}: {SUPERSTEP_ROUNDS} rounds in {len(chunks)} dispatches "
        f"(the eager loop {SUPERSTEP_ROUNDS}), bit for bit; one dispatch with no host sync; "
        f"{json.dumps(out)}")
    flash = list(attention.launches)
    nwp_tracer = Tracer()

    def nwp_superstep():
        from fedml_tpu_torch import FedAvgAPI, FedConfig, NWPTrainer, create_model

        cfg = FedConfig(dataset="stackoverflow_nwp", model="transformer_nwp",
                        client_num_in_total=NWP_CLIENTS, client_num_per_round=NWP_PER_ROUND,
                        batch_size=NWP_BATCH, lr=NWP_LR, grad_clip=1.0, epochs=1,
                        comm_round=3, rounds_per_dispatch=2, frequency_of_the_test=100,
                        seed=SEED)
        trainer = NWPTrainer(create_model("transformer_nwp", output_dim=nwp.class_num))
        api = FedAvgAPI(nwp, cfg, trainer, device="cuda")
        return api, api.train(tracer=nwp_tracer)

    (api, nwp_hist), flash_launches["transport nwp superstep"] = with_launches(
        "transport nwp superstep", flash, nwp_superstep)
    check_trained("nwp superstep", api, nwp_hist, must_fall=False)
    if [e["rounds"] for e in nwp_tracer.find_events("superstep_committed")] != [2]:
        raise RuntimeError("nwp superstep: rounds 1-2 were not one dispatch")
    out["nwp_round_ms"] = [round(h["round_time"] * 1e3, 2) for h in nwp_hist]
    t0 = time.perf_counter()
    keys = torch.from_numpy(sampling.feistel_keys_block(0, SAMPLER_ROUNDS).astype(
        np.int64)).to(device)
    host = [sampling.feistel_host(r, FLAGSHIP_CLIENTS, 10) for r in range(SAMPLER_ROUNDS)]
    # every round at once, walked the most passes any round took
    drawn = sampling.feistel_cohort_in_graph(keys, FLAGSHIP_CLIENTS, 10,
                                             walks=max(h[1] for h in host)).cpu().numpy()
    if not np.array_equal(drawn, np.stack([h[0] for h in host])):
        raise Disagreement("the device sampler differs from the host's")
    out["sampler_s"] = round(time.perf_counter() - t0, 2)
    log(f"device Feistel sampler: {FLAGSHIP_CLIENTS} clients, {SAMPLER_ROUNDS} rounds, "
        f"bit for bit the host's ({out['sampler_s']} s)")
    return out


def run_transport(ds, nwp, device, fused_launches: dict, flash_launches: dict) -> dict:
    """Phase 10: the codecs, FedBuff and the superstep (see the module
    docstring). Returns the phase's numbers."""
    import torch

    started = time.perf_counter()
    launches: dict = {}
    # cuDNN's default convolution algorithms differ from run to run in their
    # last bits (two engine runs of phase 3's configuration did, on an H100):
    # the bit-for-bit checks of this phase run on its deterministic ones
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = {"codecs": transport_codecs(ds, nwp, launches, flash_launches),
               "fedbuff": transport_buffered(ds, launches),
               "superstep": transport_superstep(ds, nwp, device, launches,
                                                flash_launches)}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for tag, counts in launches.items():
        fused_launches[tag] = counts["fused_epoch"]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - started
    if seconds > PHASE10_BUDGET_S:
        log(f"WARNING phase 10 took {seconds:.1f} s, over its {PHASE10_BUDGET_S:.0f} s "
            f"budget")
    out["seconds"] = round(seconds, 1)
    log(f"phase 10: {seconds:.1f} s")
    return out


# ----------------------------------------------------------------- phase 11


def nwp_lora_cfg(**overrides):
    """Cell 2's FedConfig behind rank-LORA_RANK LoRA (``overrides`` replace
    its fields)."""
    from fedml_tpu_torch import FedConfig

    return FedConfig(dataset="stackoverflow_nwp", model="transformer_nwp",
                     client_num_in_total=NWP_CLIENTS, client_num_per_round=NWP_PER_ROUND,
                     batch_size=NWP_BATCH, lr=NWP_LR, grad_clip=1.0, epochs=1,
                     comm_round=LORA_ROUNDS, seed=SEED, lora_rank=LORA_RANK,
                     pipeline_depth=PIPE_DEPTH).replace(**overrides)


def nwp_trainer(nwp):
    from fedml_tpu_torch import NWPTrainer, create_model

    return NWPTrainer(create_model("transformer_nwp", output_dim=nwp.class_num))


def nwp_lora_api(nwp, **overrides):
    """FedAvgAPI on the card for cell 2 behind LoRA."""
    from fedml_tpu_torch import FedAvgAPI

    return FedAvgAPI(nwp, nwp_lora_cfg(**overrides), nwp_trainer(nwp), device="cuda")


def adapter_template(api) -> dict:
    """The personal row's template: the API's adapters."""
    from fedml_tpu_torch.models.lora import strip_lora_base
    from fedml_tpu_torch.utils.pytree import split_variables

    return split_variables(strip_lora_base(api.global_variables))[0]


def resume_from(src: str, dst: str, step: int) -> None:
    """Copy checkpoint directory ``src`` to ``dst`` keeping the steps up to
    ``step``: a resume from ``dst`` starts after round ``step``."""
    import os
    import shutil

    from fedml_tpu_torch.utils.checkpoint import all_checkpoint_steps

    shutil.copytree(src, dst)
    for s in all_checkpoint_steps(dst):
        if s > step:
            os.remove(os.path.join(dst, f"meta_{s}.json"))
            shutil.rmtree(os.path.join(dst, f"ckpt_{s}"))


def records(hist, evals: bool = True) -> list:
    """The records without their times and, unless ``evals``, without the
    evaluations."""
    return [{k: v for k, v in h.items() if k != "round_time" and (evals or not k.startswith(
        ("Train/", "Test/", "Personalization/")))} for h in hist]


def dir_bytes(root: str) -> dict:
    import os

    return {n: open(os.path.join(root, n), "rb").read() for n in sorted(os.listdir(root))}


def serving_lora(nwp, reference: dict, flash_launches: dict, tmp: str) -> dict:
    """Phase 11 (a): cell 20, LoRA on cell 2."""
    import os

    import torch

    from fedml_tpu_torch.models.lora import lora_base, strip_lora_base
    from fedml_tpu_torch.ops import attention

    # every round evaluates, as phase 3's NWP path does, so the launch
    # counts compare
    api = nwp_lora_api(nwp, frequency_of_the_test=1)
    base0 = {k: v.clone() for k, v in lora_base(api.global_variables).items()}
    wire = sum(v.numel() for v in strip_lora_base(api.global_variables).values())
    total = wire + sum(v.numel() for v in base0.values())
    if wire != LORA_WIRE:
        raise RuntimeError(f"nwp lora: the wire tree holds {wire} parameters, not "
                           f"{LORA_WIRE}")
    ckpt = os.path.join(tmp, "lora_ckpt")
    flash = list(attention.launches)
    t0 = time.perf_counter()
    hist, flash_launches["lora nwp"] = with_launches(
        "lora nwp", flash, lambda: api.train(ckpt_dir=ckpt, ckpt_every=3))
    seconds = time.perf_counter() - t0
    losses = check_trained("lora nwp", api, hist)
    counts = flash_launches["lora nwp"]
    for k in flash:
        if abs(counts[k] - reference[k]) > LAUNCH_SLACK * reference[k]:
            raise RuntimeError(f"lora nwp: {k} launched {counts[k]} times, phase 3's NWP "
                               f"path {reference[k]}")
    same_bits("lora nwp: the frozen base across the run", lora_base(api.global_variables),
              base0)
    resumed_dir = os.path.join(tmp, "lora_resume")
    resume_from(ckpt, resumed_dir, 3)
    resumed = nwp_lora_api(nwp, frequency_of_the_test=1)
    rhist = resumed.train(ckpt_dir=resumed_dir)
    same_bits("lora nwp resumed 3 + 2", resumed.global_variables, api.global_variables)
    if records(rhist) != records(hist):
        raise Disagreement("lora nwp resumed 3 + 2: the records differ")
    dispatch_without_sync("lora nwp", api, LORA_ROUNDS)
    out = {"wire_params": wire, "params": total, "shrink": round(total / wire, 2),
           "train_loss": [round(v, 4) for v in losses],
           "test_acc": round(hist[-1]["Test/Acc"], 4),
           "median_round_ms": round(statistics.median(h["round_time"] * 1e3
                                                      for h in hist[1:]), 2),
           "seconds": round(seconds, 1), "launches": counts,
           "phase3_launches": {k: reference[k] for k in flash}}
    log(f"lora nwp (rank {LORA_RANK}): base bit for bit, resumed 3 + 2 bit for bit; "
        f"{json.dumps(out)}")
    return out


def pfl_run(nwp, tmp: str, tag: str, depth: int, rounds: int = LORA_ROUNDS,
            ckpt: bool = False, chaos=None, watch=None, **overrides):
    """A personalized NWP drive with a client ledger, from the bank and
    ledger directories named by ``tag`` under ``tmp`` (created on first
    use, reopened after). With ``ckpt`` the drive checkpoints every 3
    rounds into ``{tag}_ckpt``, and at step 3 also copies its bank and
    ledger directories to ``{tag}_bank@3`` and ``{tag}_ledger@3``: the
    files a resume from that checkpoint starts from. ``watch`` is called
    with the bank before the drive. Returns (api, history, bank, ledger)."""
    import os
    import shutil

    from fedml_tpu_torch.models import adapter_bank
    from fedml_tpu_torch.telemetry import client_ledger

    api = nwp_lora_api(nwp, personalize=True, pipeline_depth=depth, comm_round=rounds,
                       frequency_of_the_test=LORA_ROUNDS, **overrides)
    clusters = api.cfg.adapter_clusters
    ledger = client_ledger.open_or_create(os.path.join(tmp, f"{tag}_ledger"), NWP_CLIENTS)
    bank = adapter_bank.open_or_create(os.path.join(tmp, f"{tag}_bank"),
                                       clusters or NWP_CLIENTS, adapter_template(api))
    if watch is not None:
        watch(bank)
    if ckpt:
        save = api.save_checkpoint

        def save_with_files(ckpt_dir, step):
            save(ckpt_dir, step)
            if step == 3:
                bank.flush()
                ledger.flush()
                for what, d in (("bank", bank.root), ("ledger", ledger.root)):
                    shutil.copytree(d, os.path.join(tmp, f"{tag}_{what}@3"))

        api.save_checkpoint = save_with_files
    hist = api.train(ckpt_dir=os.path.join(tmp, f"{tag}_ckpt") if ckpt else None,
                     ckpt_every=3, chaos=chaos, ledger=ledger, bank=bank)
    ledger.flush()
    return api, hist, bank, ledger


def watch_dead_rows(plan) -> tuple:
    """(watch, seen): ``watch(bank)`` wraps the bank's gather and apply so
    that every cohort block the drive scatters is held against the rows
    it gathered for that cohort: a client ``plan`` dropped must get its row
    back bit for bit. ``seen`` counts the dead rows checked and names the
    leaves whose live rows changed."""
    import numpy as np

    seen = {"dead": 0, "changed": set()}

    def watch(bank):
        gather, apply = bank.gather, bank.apply
        gathered = []

        def spy_gather(rows):
            out = gather(rows)
            gathered.append((np.array(rows, copy=True),
                             {k: np.array(v, copy=True) for k, v in out.items()}))
            return out

        def spy_apply(block):
            if "rows" in block:
                idx = np.asarray(block["client_idx"])
                before = next(g for r, g in reversed(gathered) if np.array_equal(r, idx))
                alive = np.asarray(plan.events(block["round"], len(idx)).participation, bool)
                for k, new in block["rows"].items():
                    new = np.asarray(new)[:len(idx)]
                    if not np.array_equal(new[~alive], before[k][~alive]):
                        raise Disagreement(f"chaos: round {block['round']} changed a dead "
                                           f"client's row {k}")
                    if not np.array_equal(new[alive], before[k][alive]):
                        seen["changed"].add(k)
                seen["dead"] += int((~alive).sum())
            apply(block)

        bank.gather, bank.apply = spy_gather, spy_apply

    return watch, seen


def rss_mb() -> float:
    import os

    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2 ** 20


def keeps_holes(root: str) -> bool:
    """Whether the filesystem under ``root`` reports a truncated file's
    holes as unallocated (a probe of 64 MiB, removed after)."""
    import os

    probe = os.path.join(root, "probe")
    with open(probe, "wb") as f:
        f.truncate(RSS_GROWTH_MB * 2 ** 20)
    try:
        return os.stat(probe).st_blocks * 512 < 2 ** 20
    finally:
        os.remove(probe)


def check_big_bank(template: dict) -> dict:
    """Phase 11 (b)'s bank at StackOverflow's population: BANK_CYCLES
    gather/scatter cycles of BANK_COHORT random rows through
    ``AdapterBank.apply``; the sampled RSS may grow by under RSS_GROWTH_MB
    MB, and the physical bytes must be the touched rows' pages. Where the
    filesystem reports a truncated file as allocated (a probe file says so
    before the bank is made), the bank has SMALL_BANK_ROWS rows and only
    the RSS and the rate are checked: there the physical bytes cannot show
    which pages were written."""
    import shutil

    import numpy as np

    from fedml_tpu_torch.models import adapter_bank

    root = tempfile.mkdtemp(prefix="bank_")
    try:
        sparse = keeps_holes(root)
        rows = BIG_BANK_ROWS if sparse else SMALL_BANK_ROWS
        if not sparse:
            log(f"bank: the filesystem reports a truncated file's holes as allocated: the "
                f"check runs at {rows} rows, not {BIG_BANK_ROWS}, and holds the RSS and the "
                f"rate alone (the physical bytes cannot show the pages written)")
        bank = adapter_bank.create_bank(root, rows, template)
        rng = np.random.RandomState(SEED)
        touched = set()
        rss0 = peak = rss_mb()
        t0 = time.perf_counter()
        for cycle in range(BANK_CYCLES):
            ids = rng.choice(rows, BANK_COHORT, replace=False)
            got = bank.gather(ids)
            bank.apply({"round": cycle, "client_idx": ids,
                        "rows": {k: v + np.float32(cycle + 1) for k, v in got.items()}})
            touched.update(int(i) for i in ids)
            peak = max(peak, rss_mb())
        seconds = time.perf_counter() - t0
        nb = bank.row_nbytes
        pages = {p for r in touched for p in range(r * nb // 4096, ((r + 1) * nb - 1) // 4096 + 1)}
        physical = bank.bytes_physical()
        want = 4096 * len(pages) if sparse else None
        out = {"rows": rows, "logical_gb": round(rows * nb / 1e9, 2),
               "touched_rows": len(touched), "bytes_physical": physical,
               "bytes_expected": want, "rss_growth_mb": round(peak - rss0, 2),
               "rows_per_s": round(2 * BANK_CYCLES * BANK_COHORT / seconds, 1),
               "sparse": sparse}
        bank.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if sparse and physical != want:
        raise RuntimeError(f"bank: {physical} physical bytes, expected {want}")
    if out["rss_growth_mb"] >= RSS_GROWTH_MB:
        raise RuntimeError(f"bank: RSS grew {out['rss_growth_mb']} MB")
    log(f"bank at {rows} rows: {json.dumps(out)}")
    return out


def serving_personal(nwp, flash_launches: dict, tmp: str) -> dict:
    """Phase 11 (b): cell 21, personalized NWP from an adapter bank."""
    import os
    import shutil

    from fedml_tpu_torch.ops import attention
    from fedml_tpu_torch.robustness.chaos import FaultPlan

    flash = list(attention.launches)
    plan = FaultPlan(seed=SEED, drop_rate=PFL_DROP_RATE)
    watch, seen = watch_dead_rows(plan)
    t0 = time.perf_counter()
    (pipe, phist, pbank, pledger), flash_launches["personalized nwp"] = with_launches(
        "personalized nwp", flash,
        lambda: pfl_run(nwp, tmp, "pipe", PIPE_DEPTH, ckpt=True, chaos=plan, watch=watch))
    seconds = time.perf_counter() - t0
    check_trained("personalized nwp", pipe, phist)
    lift = phist[-1].get("Personalization/Lift")
    if lift is None or not math.isfinite(lift):
        raise RuntimeError(f"personalized nwp: Personalization/Lift {lift}")
    template = adapter_template(pipe)
    if seen["dead"] == 0 or seen["changed"] != set(template):
        raise RuntimeError(f"chaos: {seen['dead']} dead rows checked, live rows changed in "
                           f"{sorted(seen['changed'])} of {sorted(template)}")
    # the pipelined run's round-3 checkpoint, bank and ledger, resumed
    # eagerly to round 5
    resume_from(os.path.join(tmp, "pipe_ckpt"), os.path.join(tmp, "resumed_ckpt"), 3)
    for what in ("bank", "ledger"):
        shutil.copytree(os.path.join(tmp, f"pipe_{what}@3"), os.path.join(tmp, f"resumed_{what}"))
    resumed, rhist, rbank, rledger = pfl_run(nwp, tmp, "resumed", 0, ckpt=True, chaos=plan)
    tag = "eager resume 3 + 2 vs pipelined"
    same_bits(f"personalized nwp {tag}", resumed.global_variables, pipe.global_variables)
    if records(rhist) != records(phist):
        raise Disagreement(f"personalized nwp {tag}: the records differ")
    for what, a, b in (("bank", rbank.root, pbank.root), ("ledger", rledger.root,
                                                          pledger.root)):
        if dir_bytes(a) != dir_bytes(b):
            raise Disagreement(f"personalized nwp {tag}: the {what} files differ")
    dispatch_without_sync("personalized nwp", pipe, LORA_ROUNDS, chaos=plan)
    # cluster rows: 4 shared rows assigned from the ledger's EMA loss
    capi, chist, cbank, _ = pfl_run(nwp, tmp, "clusters", 0, rounds=2, adapter_clusters=4)
    check_trained("personalized nwp, 4 clusters", capi, chist, must_fall=False)
    mat = cbank.materialized_column()
    if mat.shape != (4,) or not mat.any():
        raise RuntimeError(f"clusters: bank rows {mat}")
    for bank in (pbank, rbank, cbank):
        bank.close()
    out = {"lift": lift, "dead_rows": seen["dead"], "cluster_rows_used": int(mat.sum()),
           "median_round_ms": round(statistics.median(h["round_time"] * 1e3
                                                      for h in phist[1:]), 2),
           "seconds": round(seconds, 1), "launches": flash_launches["personalized nwp"],
           "bank": check_big_bank(template)}
    log(f"personalized nwp (drops at {PFL_DROP_RATE}): pipelined and its eager resume 3 + 2 "
        f"bit for bit (globals, records, bank, ledger); dead rows kept; {json.dumps(out)}")
    return out


def serving_tenants(ds, nwp, flash_launches: dict, tmp: str) -> dict:
    """Phase 11 (c): cell 22, three tenants under one Scheduler."""
    import os

    import torch

    import dataclasses
    import gc

    from fedml_tpu_torch import ClassificationTrainer, FedConfig, create_model, telemetry
    from fedml_tpu_torch.models import adapter_bank
    from fedml_tpu_torch.ops import attention, fused_sgd
    from fedml_tpu_torch.robustness.chaos import FaultPlan
    from fedml_tpu_torch.serving import JobDescriptor, Scheduler, params_equal

    femnist = FedConfig(dataset="femnist", model="cnn", client_num_in_total=FEMNIST_CLIENTS,
                        client_num_per_round=10, batch_size=BATCH, lr=0.1, grad_clip=1.0,
                        epochs=1, comm_round=SERVE_ROUNDS, seed=SEED)
    pfl_cfg = nwp_lora_cfg(personalize=True, comm_round=PFL_SERVE_ROUNDS,
                           frequency_of_the_test=PFL_SERVE_ROUNDS)

    def cnn():
        return ClassificationTrainer(create_model("cnn", output_dim=ds.class_num))

    def tenants(bank):
        return [JobDescriptor("femnist-sync", femnist, ds, trainer_factory=cnn),
                JobDescriptor("femnist-fedbuff", femnist.replace(
                    buffer_size=BUFF_SIZE, staleness_alpha=BUFF_ALPHA), ds,
                    trainer_factory=cnn, partial_dispatch=True,
                    chaos=FaultPlan(seed=SEED, straggler_rate=STRAGGLER_RATE,
                                    straggler_rounds=STRAGGLER_ROUNDS)),
                JobDescriptor("nwp-personalized", pfl_cfg, nwp, bank=bank, slo="latency",
                              deadline_s=PFL_DEADLINE_S,
                              trainer_factory=lambda: nwp_trainer(nwp))]

    template = adapter_template(nwp_lora_api(nwp))

    def bank(tag):
        return adapter_bank.create_bank(os.path.join(tmp, tag), NWP_CLIENTS, template)

    # each tenant alone: partial dispatch runs as a lone job (the drive
    # loops have no partial mode), the others through FedAvgAPI.train
    solo_bank = bank("solo_bank")
    solo = {}
    for desc in tenants(solo_bank):
        if desc.partial_dispatch:
            job, tracer = desc.build(), telemetry.Tracer()
            while not job.step(tracer):
                pass
            solo[desc.name] = job.final_params()
        else:
            api = desc.build_api()
            api.train(chaos=desc.chaos, bank=desc.bank)
            solo[desc.name] = {k: v.cpu() for k, v in api.global_variables.items()}
    del api, job
    solo_bank.close()
    torch.cuda.synchronize()
    served_bank = bank("served_bank")
    tracer = telemetry.Tracer()
    sched = Scheduler("fair_share", tracer=tracer, max_resident=2,
                      spill_dir=os.path.join(tmp, "spill"))
    freed = []
    evict = sched._evict

    def measured_evict(job, reason="preempted"):
        # the eviction collects cyclic garbage: collect the process's first,
        # so the fall is the tenant's alone
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        evict(job, reason)
        torch.cuda.synchronize()
        freed.append((job.name, before, torch.cuda.memory_allocated()))

    sched._evict = measured_evict
    sync, fedbuff, pfl = tenants(served_bank)
    launches = {d.name: {"fused_epoch": 0, **dict.fromkeys(attention.launches, 0)}
                for d in (sync, fedbuff, pfl)}
    sched.submit(sync)
    sched.submit(fedbuff)
    order = []
    t0 = time.perf_counter()
    while True:
        if len(order) == 2:
            sched.submit(pfl)
        fused_sgd.launches = 0
        for k in attention.launches:
            attention.launches[k] = 0
        name = sched.tick()
        if name is None:
            break
        order.append(name)
        for k, v in {"fused_epoch": fused_sgd.launches, **attention.launches}.items():
            launches[name][k] += v
    seconds = time.perf_counter() - t0
    slo_ok, slo_report = sched.check_slo()
    sched.close()
    served_bank.close()
    for name, want in solo.items():
        job = sched.queue.get(name)
        if not job.done or not params_equal(job.final_params(), want):
            raise Disagreement(f"serving: tenant {name} differs from its solo run")
    if dir_bytes(served_bank.root) != dir_bytes(solo_bank.root):
        raise Disagreement("serving: the personalized tenant's bank differs from its solo "
                           "run's")
    if sched.evictions < 1 or not freed:
        raise RuntimeError(f"serving: no eviction (order {order})")
    for name, before, after in freed:
        if not after < before:
            raise RuntimeError(f"serving: evicting {name} left the allocated bytes at "
                               f"{after} (from {before})")
    if any(any(c.values()) for c in sched.compile_ledger.values()):
        raise RuntimeError(f"serving: compile ledger {sched.compile_ledger}")
    for name, counts in launches.items():
        flash = sum(counts[k] for k in attention.launches)
        if counts["fused_epoch"] or (flash > 0) != (name == "nwp-personalized"):
            raise RuntimeError(f"serving: tenant {name} launched {counts}")
    flash_launches["serving nwp tenant"] = {k: launches["nwp-personalized"][k]
                                            for k in attention.launches}
    log(f"serving: check_slo ok={slo_ok}\n{slo_report}")
    # admission control: past max_queued 1, "reject" bounces a submission
    gate_tracer = telemetry.Tracer()
    gate = Scheduler(tracer=gate_tracer, admission="reject", max_queued=1, max_resident=1)
    first = gate.submit(sync)
    bounced = gate.submit(dataclasses.replace(fedbuff, name="fourth"))
    gate.close()
    if first is None or bounced is not None or gate.rejections != 1:
        raise RuntimeError("serving: admission reject did not bounce the fourth submission")
    out = {"order": order, "evictions": sched.evictions,
           "freed_mb": [round((b - a) / 2 ** 20, 2) for _, b, a in freed],
           "resumptions": len(tracer.find_events("job_resumed")),
           "launches": launches, "slo_ok": slo_ok, "seconds": round(seconds, 1),
           "latency_s": sched.slo_ledger.get("nwp-personalized", {}).get("latency_s")}
    log(f"serving (fair share, 2 slots): every tenant bit for bit its solo run; "
        f"{json.dumps(out)}")
    return out


def run_serving(ds, nwp, reference: dict, flash_launches: dict) -> dict:
    """Phase 11: LoRA, personalization and serving (see the module
    docstring). ``reference`` is phase 3's NWP flash launches. Returns the
    phase's numbers."""
    import torch

    started = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = {"lora": serving_lora(nwp, reference, flash_launches, tmp),
                   "personalized": serving_personal(nwp, flash_launches, tmp),
                   "tenants": serving_tenants(ds, nwp, flash_launches, tmp)}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize()
    seconds = time.perf_counter() - started
    if seconds > PHASE11_BUDGET_S:
        log(f"WARNING phase 11 took {seconds:.1f} s, over its {PHASE11_BUDGET_S:.0f} s "
            f"budget")
    out["seconds"] = round(seconds, 1)
    log(f"phase 11: {seconds:.1f} s")
    return out


# ---- phase 12: the FedAvg family's last datasets (cells 23-27)


def dataset_path(tag: str, fused_launches: dict, flash_launches: dict, fn):
    """A phase 12 path: ``fn()`` with the four kernels' launches counted
    (each must read 0, see ``zoo_path``), filed under ``tag``. The earlier
    paths' garbage is collected first, so that the RSS a streamed round
    samples is not theirs."""
    import gc

    from fedml_tpu_torch.ops import attention

    gc.collect()
    counts: dict = {}
    out = zoo_path(tag, counts, fn)
    fused_launches[tag] = counts[tag]["fused_epoch"]
    flash_launches[tag] = {k: counts[tag][k] for k in attention.launches}
    return out


def run_tag_prediction() -> dict:
    """Phase 12 (a), cell 23: stackoverflow_lr with lr at full width."""
    from fedml_tpu_torch import FedAvgAPI, FedConfig, create_model, load_dataset
    from fedml_tpu_torch.core.trainer import TagPredictionTrainer
    from fedml_tpu_torch.experiments import profile_zoo

    t0 = time.perf_counter()
    ds = load_dataset("stackoverflow_lr", client_num_in_total=SO_LR_CLIENTS, seed=SEED)
    built = time.perf_counter() - t0
    cfg = FedConfig(dataset="stackoverflow_lr", model="lr", client_num_in_total=SO_LR_CLIENTS,
                    client_num_per_round=SO_LR_PER_ROUND, batch_size=SO_LR_BATCH,
                    lr=SO_LR_LR, epochs=1, comm_round=SO_LR_ROUNDS, seed=SEED)
    trainer = TagPredictionTrainer(create_model("lr", output_dim=ds.class_num,
                                                input_shape=ds.train.x.shape[2:]))
    api = FedAvgAPI(ds, cfg, trainer, device="cuda")
    hist = api.train()
    losses = check_trained("stackoverflow_lr", api, hist)
    m = {k: float(v) for k, v in api.eval_fn(api.global_variables,
                                              *api._test_batches).items()}
    precision = m["test_precision"] / m["test_total"]
    recall = m["test_recall"] / m["test_total"]
    if not (0.0 <= precision <= 1.0 and 0.0 <= recall <= 1.0):
        raise RuntimeError(f"stackoverflow_lr: precision {precision}, recall {recall}")
    if "correct" in hist[-1]:
        raise RuntimeError("stackoverflow_lr: a train record carries the classifier's "
                           "'correct' sum")
    # one more round under the profiler, the device's activity alone
    prof = profile_zoo.profiled_round(api, len(hist), host_events=False)
    log(profile_zoo.summary("stackoverflow_lr", hist, prof))
    out = {"params": sum(v.numel() for v in api.global_variables.values()),
           "train_bce": [round(v, 5) for v in losses],
           "test_precision": round(precision, 4), "test_recall": round(recall, 4),
           "exact_match": round(m["test_correct"] / m["test_total"], 4),
           "round_ms": [round(h["round_time"] * 1e3, 2) for h in hist],
           "set_up_s": round(built, 1), "profiled_wall_ms": round(prof["wall_ms"], 2),
           "busy_ms": round(prof["busy_ms"], 2),
           "busy_share": round(prof["busy_ms"] / prof["wall_ms"], 4)}
    log(f"stackoverflow_lr (lr 10,000 -> 500, {SO_LR_CLIENTS} clients): {json.dumps(out)}")
    return out


def lora_lstm_run(tag: str, ds, model: str, rounds: int, **cfg_kw) -> dict:
    """A LoRA (rank LORA_RANK) drive of an LSTM on the card: the frozen
    base bit for bit, the wire's parameters beside the model's; over more
    than one round the training loss and the global test loss (one fixed
    set, before and after) fall."""
    from fedml_tpu_torch import FedAvgAPI, FedConfig, NWPTrainer, create_model
    from fedml_tpu_torch.core.trainer import ClassificationTrainer
    from fedml_tpu_torch.models.lora import lora_base, strip_lora_base

    module = create_model(model, output_dim=ds.class_num)
    trainer = (NWPTrainer(module) if ds.meta.get("task") == "nwp"
               else ClassificationTrainer(module))
    cfg = FedConfig(model=model, lora_rank=LORA_RANK, epochs=1, comm_round=rounds,
                    seed=SEED, frequency_of_the_test=rounds, **cfg_kw)
    api = FedAvgAPI(ds, cfg, trainer, device="cuda")
    base0 = {k: v.clone() for k, v in lora_base(api.global_variables).items()}
    wire = sum(v.numel() for v in strip_lora_base(api.global_variables).values())
    total = sum(v.numel() for v in base0.values())
    before = api.test_global(-1)["Test/Loss"]
    hist = api.train()
    losses = check_trained(tag, api, hist, must_fall=rounds > 1)
    after = api.test_global(rounds)["Test/Loss"]
    if rounds > 1 and not after < before:
        raise RuntimeError(f"{tag}: the global test loss did not fall: {before} -> {after}")
    same_bits(f"{tag}: the frozen base across the run", lora_base(api.global_variables),
              base0)
    out = {"wire_params": wire, "model_params": total, "shrink": round(total / wire, 2),
           "train_loss": [round(v, 5) for v in losses],
           "test_loss": [before, after],
           "round_ms": [round(h["round_time"] * 1e3, 2) for h in hist]}
    log(f"{tag} (rank {LORA_RANK}): base bit for bit; {json.dumps(out)}")
    return out


def run_lora_stackoverflow(nwp) -> dict:
    """Phase 12 (b), cell 24: LoRA over rnn_stackoverflow's gate kernels on
    cell 2's data, pipelined."""
    return lora_lstm_run("lora rnn_stackoverflow", nwp, "rnn_stackoverflow", LSTM_LORA_ROUNDS,
                         dataset="stackoverflow_nwp", client_num_in_total=NWP_CLIENTS,
                         client_num_per_round=NWP_PER_ROUND, batch_size=NWP_BATCH,
                         lr=LSTM_LORA_LR, grad_clip=1.0, pipeline_depth=PIPE_DEPTH)


def run_lora_shakespeare() -> dict:
    """Phase 12 (b): one LoRA round of the Shakespeare LSTM (phase 5's
    configuration)."""
    from fedml_tpu_torch import load_dataset

    shakespeare = load_dataset("shakespeare", client_num_in_total=715, seed=SEED)
    return lora_lstm_run("lora rnn", shakespeare, "rnn", 1, dataset="shakespeare",
                         client_num_in_total=715, client_num_per_round=10, batch_size=10,
                         lr=0.8)


class BudgetWatch:
    """Wraps a streaming store's ``select`` to check, after every call,
    that the resident bytes are within its budget, that every sampled
    client is resident and every resident one was sampled by some select;
    counts evictions and samples the process's RSS (MiB) with the time."""

    def __init__(self, tag: str, store):
        self.tag, self.store = tag, store
        self.selects = self.evictions = 0
        self.sampled: set = set()
        self.rss: list = []
        self._select = store.select
        store.select = self

    def __call__(self, idx):
        before = set(self.store.resident_clients())
        out = self._select(idx)
        resident = set(self.store.resident_clients())
        self.sampled |= {int(k) for k in idx}
        self.selects += 1
        self.evictions += len(before - resident)
        if self.store.resident_bytes > self.store.byte_budget:
            raise RuntimeError(f"{self.tag}: {self.store.resident_bytes} resident bytes over "
                               f"the {self.store.byte_budget}-byte budget")
        if not {int(k) for k in idx} <= resident or not resident <= self.sampled:
            raise RuntimeError(f"{self.tag}: resident clients {sorted(resident)} after "
                               f"sampling {sorted(int(k) for k in idx)}")
        self.rss.append((time.perf_counter(), rss_mb()))
        return out


def streamed_rounds(tag: str, ds, cfg, trainer) -> dict:
    """The drive over a streaming dataset on the card, each split's
    ``select`` watched (``BudgetWatch``); per round: its time, its
    ``stage`` span and the peak RSS sampled in it. At least one eviction."""
    from fedml_tpu_torch import FedAvgAPI
    from fedml_tpu_torch.telemetry import Tracer

    watches = [BudgetWatch(f"{tag} {split}", getattr(ds, split)) for split in ("train", "test")]
    api = FedAvgAPI(ds, cfg, trainer, device="cuda")
    tracer = Tracer()
    hist = api.train(tracer=tracer)
    check_trained(tag, api, hist, must_fall=False)
    rounds = []
    for span in tracer.find_spans("round"):
        t0, t1 = span["t0"], span["t0"] + span["dur_s"]
        peak = max((m for t, m in watches[0].rss + watches[1].rss if t0 <= t <= t1),
                   default=rss_mb())
        stage = sum(s["dur_s"] for s in tracer.find_spans("stage", span["round"]))
        rounds.append({"round": span["round"], "round_ms": round(span["dur_s"] * 1e3, 2),
                       "stage_ms": round(stage * 1e3, 2), "peak_rss_mb": round(peak, 1)})
    evictions = sum(w.evictions for w in watches)
    if evictions == 0:
        raise RuntimeError(f"{tag}: no client was evicted under the "
                           f"{ds.train.byte_budget}-byte budget")
    resident = tracer.gauge_summary()["store_resident_bytes"]["last"]
    out = {"rounds": rounds, "selects": sum(w.selects for w in watches),
           "evictions": evictions, "budget_mb": ds.train.byte_budget >> 20,
           "row_mb": round(ds.train.row_bytes() / 2 ** 20, 2),
           "last_resident_gauge": resident,
           "train_loss": [round(h["loss_sum"] / h["total"], 4) for h in hist]}
    log(f"{tag}: every select within the budget; {json.dumps(out)}")
    return out


def seeded_pool(n: int, side: int, classes: int, seed: int) -> list:
    """n seeded uint8 images [side, side, 3], image p a noisy copy of
    class p % classes's prototype (so the labels can be learned)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    protos = rng.rand(classes, side, side, 3).astype(np.float32)
    return [((0.7 * protos[p % classes] + 0.3 * rng.rand(side, side, 3)) * 255).astype(np.uint8)
            for p in range(n)]


def write_pool(root: str, pool) -> list:
    """The pool's images as JPEG files under ``root``."""
    import os

    from PIL import Image

    os.makedirs(root, exist_ok=True)
    paths = []
    for p, img in enumerate(pool):
        paths.append(os.path.join(root, f"p{p:05d}.jpg"))
        Image.fromarray(img).save(paths[-1], quality=90)
    return paths


def gld_users(rng) -> list:
    """GLD_USERS seeded per-user row counts (at least 30, as gld23k's
    users hold) summing to GLD_ROWS."""
    import numpy as np

    n = np.clip(rng.lognormal(np.log(GLD_ROWS / GLD_USERS), 0.45, GLD_USERS), 30, 300)
    n = np.maximum(30, np.floor(n * GLD_ROWS / n.sum())).astype(int)
    short = GLD_ROWS - int(n.sum())
    n[np.argsort(-n)[:abs(short)]] += int(np.sign(short))
    return [int(v) for v in n]


def run_gld23k(root: str) -> dict:
    """Phase 12 (c), cell 25: gld23k streamed at its published federation."""
    import os

    import numpy as np

    from fedml_tpu_torch import FedConfig, create_model, load_dataset
    from fedml_tpu_torch.core.trainer import ClassificationTrainer

    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED + 25)
    # the images at <root>/images/<image_id>.jpg, a place the loader reads
    write_pool(os.path.join(root, "images"),
               seeded_pool(GLD_POOL, GLD_SIDE, GLD_CLASSES, SEED + 25))
    per_class = [list(range(c, GLD_POOL, GLD_CLASSES)) for c in range(GLD_CLASSES)]

    def rows(n):
        cls = rng.randint(0, GLD_CLASSES, n)
        return [(int(c), per_class[c][rng.randint(len(per_class[c]))]) for c in cls]

    users = [rows(n) for n in gld_users(rng)]
    os.makedirs(os.path.join(root, "data_user_dict"))
    for split, table in (("train", [(u, r) for u, rs in enumerate(users) for r in rs]),
                         ("test", [(0, r) for r in rows(GLD_TEST_ROWS)])):
        with open(os.path.join(root, "data_user_dict", f"gld23k_user_dict_{split}.csv"),
                  "w") as f:
            f.write("user_id,image_id,class\n")
            f.writelines(f"{u},p{p:05d},{c}\n" for u, (c, p) in table)
    written = time.perf_counter() - t0
    budget = os.environ.get("FEDML_TPU_STREAM_BUDGET")
    os.environ["FEDML_TPU_STREAM_BUDGET"] = str(STREAM_BUDGET)
    try:
        ds = load_dataset("gld23k", data_dir=root, image_size=GLD_SIDE, seed=SEED)
    finally:
        if budget is None:
            del os.environ["FEDML_TPU_STREAM_BUDGET"]
        else:
            os.environ["FEDML_TPU_STREAM_BUDGET"] = budget
    loaded = time.perf_counter() - t0 - written
    if (ds.train.num_clients, ds.train.total_samples) != (GLD_USERS, GLD_ROWS):
        raise RuntimeError(f"gld23k: {ds.train.num_clients} users, "
                           f"{ds.train.total_samples} rows")
    cfg = FedConfig(dataset="gld23k", model="mobilenet_v3", client_num_in_total=GLD_USERS,
                    client_num_per_round=GLD_PER_ROUND, batch_size=GLD_BATCH, lr=GLD_LR,
                    epochs=1, comm_round=GLD_ROUNDS, frequency_of_the_test=GLD_ROUNDS,
                    ci=STREAM_EVAL_CI, seed=SEED)
    trainer = ClassificationTrainer(create_model("mobilenet_v3", output_dim=ds.class_num,
                                                 input_shape=ds.train.x.shape[2:]))
    out = streamed_rounds("gld23k streaming", ds, cfg, trainer)
    out.update(users=GLD_USERS, rows=GLD_ROWS, distinct_images=GLD_POOL, n_max=ds.train.n_max,
               class_num=ds.class_num, written_s=round(written, 1), load_s=round(loaded, 1),
               decoded_federation_gb=round(GLD_ROWS * GLD_SIDE ** 2 * 3 * 4 / 1e9, 3))
    return out


def run_imagenet(root: str) -> dict:
    """Phase 12 (d), cell 26: one ILSVRC2012 round at 224 px, streamed."""
    import os
    import shutil

    from fedml_tpu_torch import FedConfig, create_model, load_dataset
    from fedml_tpu_torch.core.trainer import ClassificationTrainer

    t0 = time.perf_counter()
    pool = write_pool(os.path.join(root, "pool"),
                      seeded_pool(INET_POOL, INET_SIDE, 16, SEED + 26))
    for split, per in (("train", INET_TRAIN_PER_CLASS), ("val", INET_VAL_PER_CLASS)):
        for c in range(INET_CLASSES):
            d = os.path.join(root, split, f"n{c:08d}")
            os.makedirs(d)
            for i in range(per):
                shutil.copyfile(pool[(c * per + i) % INET_POOL], os.path.join(d, f"img_{i}.jpg"))
    written = time.perf_counter() - t0
    ds = load_dataset("ILSVRC2012", data_dir=root, client_num_in_total=INET_CLIENTS,
                      image_size=INET_SIDE, byte_budget=STREAM_BUDGET, seed=SEED)
    loaded = time.perf_counter() - t0 - written
    cfg = FedConfig(dataset="ILSVRC2012", model="resnet18_gn", client_num_in_total=INET_CLIENTS,
                    client_num_per_round=INET_PER_ROUND, batch_size=INET_BATCH, lr=0.1,
                    epochs=1, comm_round=1, seed=SEED)
    trainer = ClassificationTrainer(create_model("resnet18_gn", output_dim=ds.class_num,
                                                 input_shape=ds.train.x.shape[2:]))
    out = streamed_rounds("ILSVRC2012 streaming", ds, cfg, trainer)
    out.update(clients=INET_CLIENTS, classes=ds.class_num, n_max=ds.train.n_max,
               written_s=round(written, 1), load_s=round(loaded, 1))
    return out


def run_augment() -> dict:
    """Phase 12 (e), cell 27: a CIFAR-10 ResNet-20 round with the reference's
    train transform as the trainer's augment_fn, twice from one seed (bit
    for bit under cuDNN's deterministic algorithms)."""
    import torch

    from fedml_tpu_torch import FedAvgAPI, FedConfig, create_model, load_dataset
    from fedml_tpu_torch.core.trainer import ClassificationTrainer
    from fedml_tpu_torch.data.augment import cifar_train_augment

    ds = load_dataset("cifar10", client_num_in_total=AUG_CLIENTS, partition_method="hetero",
                      partition_alpha=0.5, seed=SEED)
    calls = []

    def augment(generator, x):
        if generator.device != x.device:
            raise RuntimeError(f"cifar10 augment: a {generator.device} generator for a "
                               f"batch on {x.device}")
        calls.append(1)
        return cifar_train_augment(generator, x)

    runs = []
    for _ in range(2):
        cfg = FedConfig(dataset="cifar10", model="resnet20", client_num_in_total=AUG_CLIENTS,
                        client_num_per_round=AUG_CLIENTS, batch_size=AUG_BATCH, lr=AUG_LR,
                        epochs=1, comm_round=1, seed=SEED)
        trainer = ClassificationTrainer(create_model("resnet20", output_dim=ds.class_num),
                                        augment_fn=augment)
        api = FedAvgAPI(ds, cfg, trainer, device="cuda")
        hist = api.train()
        check_trained("cifar10 augment", api, hist, must_fall=False)
        runs.append((api, hist, len(calls)))
    same_bits("cifar10 augment: two runs from one seed", runs[1][0].global_variables,
              runs[0][0].global_variables)
    steps = runs[0][2]
    if steps == 0 or runs[1][2] != 2 * steps:
        raise RuntimeError(f"cifar10 augment: {steps} and {runs[1][2] - steps} augmented "
                           "batches")
    dev = runs[0][0].device
    x = torch.from_numpy(ds.train.x[0][:AUG_BATCH]).to(dev)
    y = cifar_train_augment(torch.Generator(device=dev).manual_seed(SEED), x)
    if y.shape != x.shape or torch.equal(y, x):
        raise RuntimeError("cifar10 augment: the augmented batch is the input")
    out = {"augmented_batches": steps, "round_ms": round(runs[0][1][0]["round_time"] * 1e3, 2),
           "second_run_ms": round(runs[1][1][0]["round_time"] * 1e3, 2),
           "changed_share": round(float((y != x).float().mean()), 4)}
    log(f"cifar10 resnet20 with cifar_train_augment: two runs bit for bit; {json.dumps(out)}")
    return out


def run_datasets(nwp, fused_launches: dict, flash_launches: dict) -> dict:
    """Phase 12: the FedAvg family's last datasets (cells 23-27; see the
    module docstring), every path's kernel launches counted."""
    import importlib.util

    import torch

    started = time.perf_counter()
    # decided once, here: the streaming loaders decode with PIL
    pil = importlib.util.find_spec("PIL") is not None
    log(f"phase 12: PIL {'imports' if pil else 'is absent'} on this machine")
    if not pil:
        raise RuntimeError("phase 12's streaming paths decode JPEG trees with PIL, "
                           "which this machine lacks")
    log(f"phase 12 cuts: {json.dumps(PHASE12_CUTS)}")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        def path(tag, fn):
            return dataset_path(tag, fused_launches, flash_launches, fn)

        out["stackoverflow_lr"] = path("stackoverflow_lr", run_tag_prediction)
        out["lora_rnn_stackoverflow"] = path("lora rnn_stackoverflow",
                                             lambda: run_lora_stackoverflow(nwp))
        out["lora_rnn"] = path("lora rnn", run_lora_shakespeare)
        with tempfile.TemporaryDirectory() as tmp:
            out["gld23k"] = path("gld23k streaming", lambda: run_gld23k(f"{tmp}/gld"))
            out["ILSVRC2012"] = path("ILSVRC2012 streaming",
                                     lambda: run_imagenet(f"{tmp}/inet"))
        out["cifar10_augment"] = path("cifar10 augment", run_augment)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize()
    seconds = time.perf_counter() - started
    if seconds > PHASE12_BUDGET_S:
        log(f"WARNING phase 12 took {seconds:.1f} s, over its {PHASE12_BUDGET_S:.0f} s "
            f"budget")
    out["seconds"] = round(seconds, 1)
    log(f"phase 12: {seconds:.1f} s")
    return out


# ---- phase 13: the algorithm zoo's first four (cells 28-31)


def first_clients(ds, k: int):
    """``ds`` cut to its first ``k`` clients."""
    import dataclasses

    from fedml_tpu_torch.data.packing import PackedClients

    return dataclasses.replace(ds, train=PackedClients(
        ds.train.x[:k], ds.train.y[:k], ds.train.counts[:k]))


def hierarchical_api(ds, rounds: int):
    from fedml_tpu_torch import HierarchicalFLAPI

    cfg = femnist_cfg(ds.client_num, rounds, ds.client_num)
    return HierarchicalFLAPI(ds, cfg, cnn_trainer(ds), group_num=HIER_GROUPS,
                             group_comm_round=HIER_INNER, device="cuda")


def run_hierarchical(ds) -> dict:
    """Phase 13 (a), cell 28: hierarchical FL on phase 3's FEMNIST cut."""
    from fedml_tpu_torch import HierarchicalFLAPI
    from fedml_tpu_torch.experiments.profile_fused import measure_rounds

    t0 = time.perf_counter()
    api = hierarchical_api(ds, HIER_ROUNDS)
    set_up = time.perf_counter() - t0
    with TimedRounds(HierarchicalFLAPI) as timed:
        hist = api.train()
    losses = check_trained("hierarchical", api, hist)
    # a profiled round of the same configuration on its first clients: the
    # device's activity alone
    small = hierarchical_api(first_clients(ds, HIER_PROFILED_CLIENTS), 1)
    prof = measure_rounds(small.train_one_round, 1, host_events=False)
    out = {"groups": [len(g) for g in api.groups], "inner_rounds": HIER_INNER,
           "set_up_s": round(set_up, 2),
           "round_ms": [round(ms, 2) for ms in timed.ms[0]],
           "train_loss": [round(v, 5) for v in losses],
           "test_acc": [round(h["Test/Acc"], 4) for h in hist],
           "test_loss": [round(h["Test/Loss"], 5) for h in hist],
           f"profiled_{HIER_PROFILED_CLIENTS}_clients": {
               "wall_ms": round(prof["wall_ms"], 2), "busy_ms": round(prof["busy_ms"], 2),
               "busy_share": round(prof["busy_ms"] / prof["wall_ms"], 4),
               "launches": int(prof["launches"])}}
    log(f"hierarchical (CNN_DropOut, {ds.client_num} clients in {HIER_GROUPS} groups, "
        f"{HIER_INNER} inner rounds): {json.dumps(out)}")
    return out


def run_ci_oracles() -> dict:
    """Phase 13 (b): the JAX package's CI oracles on the card
    (tests/test_algorithms.py:109-141): hierarchical with 1 group and K = 1
    is the FedAvg engine round (1e-5), 3 groups are centralized GD (Test/Acc
    and Test/Loss within 2e-3), MNIST lr at full batch."""
    import numpy as np

    from fedml_tpu_torch import (CentralizedTrainer, ClassificationTrainer, FedAvgAPI,
                                 FedConfig, HierarchicalFLAPI, create_model, load_dataset)

    ds = load_dataset("mnist", client_num_in_total=ORACLE_CLIENTS, partition_method="homo",
                      seed=3)
    kw = dict(dataset="mnist", model="lr", batch_size=-1, epochs=1, lr=0.05, comm_round=2,
              grad_clip=None, client_num_in_total=ORACLE_CLIENTS,
              client_num_per_round=ORACLE_CLIENTS, seed=SEED)

    def trainer():
        return ClassificationTrainer(create_model("lr", output_dim=ds.class_num,
                                                  input_shape=ds.train.x.shape[2:]))

    cfg = FedConfig(**kw)
    flat = FedAvgAPI(ds, cfg, trainer(), device="cuda")
    hier = HierarchicalFLAPI(ds, cfg, trainer(), group_num=1, group_comm_round=1,
                             group_assignment=[np.arange(ORACLE_CLIENTS)], device="cuda")
    hier.global_variables = dict(flat.global_variables)
    for r in range(2):
        flat.train_one_round(r)
        hier.train_one_round(r)
    flat_gap = max_diff(hier.global_variables, flat.global_variables)
    if not flat_gap < 1e-5:
        raise RuntimeError(f"hierarchical (1 group, K = 1) is {flat_gap} from FedAvg")
    cfg3 = cfg.replace(comm_round=3)
    h3 = HierarchicalFLAPI(ds, cfg3, trainer(), group_num=3, device="cuda")
    cen = CentralizedTrainer(ds, cfg3, trainer(), device="cuda")
    cen.global_variables = dict(h3.global_variables)
    for r in range(3):
        h3.train_one_round(r)
    cen.train(3)
    ha, ca = h3.eval_global(), cen.eval_global()
    gaps = {k: abs(ha[k] - ca[k]) for k in ("Test/Acc", "Test/Loss")}
    if not all(g < 2e-3 for g in gaps.values()):
        raise RuntimeError(f"3 groups against centralized: {gaps}")
    out = {"flat_fedavg_max_diff": flat_gap, "centralized_gaps": gaps,
           "hierarchical_test": ha}
    log(f"CI oracles on the card: {json.dumps(out)}")
    return out


def run_centralized(ds) -> dict:
    """Phase 13 (c), cell 29: the centralized trainer on (a)'s union."""
    import dataclasses

    import numpy as np

    from fedml_tpu_torch import CentralizedTrainer
    from fedml_tpu_torch.telemetry.records import fetch_scalars

    counts = ds.train.counts
    union = dataclasses.replace(ds, train_global=(
        np.concatenate([ds.train.x[i, :c] for i, c in enumerate(counts)]),
        np.concatenate([ds.train.y[i, :c] for i, c in enumerate(counts)])))
    cfg = femnist_cfg(ds.client_num, CENTRAL_ROUNDS, 1)
    api = CentralizedTrainer(union, cfg, cnn_trainer(ds), device="cuda")
    hist = []
    for r in range(CENTRAL_ROUNDS):
        t0 = time.perf_counter()
        m = api.train_one_round(r)
        m = dict(zip(m, fetch_scalars(list(m.values()))))
        hist.append({**m, "round_time": time.perf_counter() - t0, **api.eval_global()})
    losses = check_trained("centralized", api, hist)
    out = {"rows": api.count, "steps_a_round": -(-api.count // BATCH),
           "round_ms": [round(h["round_time"] * 1e3, 2) for h in hist],
           "train_loss": [round(v, 5) for v in losses],
           "test_acc": [round(h["Test/Acc"], 4) for h in hist],
           "test_loss": [round(h["Test/Loss"], 5) for h in hist]}
    if not all(0.0 <= a <= 1.0 for a in out["test_acc"]):
        raise RuntimeError(f"centralized: Test/Acc {out['test_acc']}")
    log(f"centralized (CNN_DropOut on the union): {json.dumps(out)}")
    return out


def run_turboaggregate(ds) -> dict:
    """Phase 13 (d), cell 30: TurboAggregate on phase 3's engine
    configuration; each round's secure global against the plain mean of the
    same host trees under the same rounded weights (the surrogate's
    clients hold 38-200 rows, so the rounded weights are not the counts'
    exact shares: that gap is printed, not held)."""
    import numpy as np
    import torch

    from fedml_tpu_torch import TurboAggregateAPI

    cfg = femnist_cfg(ds.client_num, TA_ROUNDS, 10)
    api = TurboAggregateAPI(ds, cfg, cnn_trainer(ds), num_groups=TA_GROUPS,
                            frac_bits=TA_FRAC_BITS, device="cuda")
    limit = 4 * 2.0 ** -TA_FRAC_BITS
    rounds, last = [], {}
    secure_rows = api.agg.secure_weighted_rows

    def checked(rows, weights, groups):
        out = secure_rows(rows, weights, groups)
        rows = rows.astype(np.float64)
        wq = api.agg.weight_quanta(weights)[0]
        gap = float(np.abs(out - (wq[:, None] * rows).sum(0) / wq.sum()).max())
        if not gap < limit:
            raise RuntimeError(f"turboaggregate: the secure global is {gap} from the plain "
                               f"mean under the same weights (limit {limit})")
        share = weights / weights.sum()
        rounds.append({**{f"{k}_s": round(v, 3) for k, v in api.agg.seconds.items()},
                       "max_gap": gap, "gap_to_count_weighted_mean": float(
                           np.abs(out - (share[:, None] * rows).sum(0)).max()),
                       "weight_quanta": [int(w) for w in wq]})
        last.update(out=out, params=rows.shape[1])
        return out

    api.agg.secure_weighted_rows = checked
    with TimedRounds(TurboAggregateAPI) as timed:
        hist = api.train()
    on_card = torch.cat([v.reshape(-1) for v in api.global_variables.values()]).cpu()
    if not torch.equal(on_card, torch.from_numpy(last["out"])):
        raise RuntimeError("turboaggregate: the global on the card is not the secure sum")
    for rec, h, ms in zip(rounds, hist, timed.ms[0]):
        rec.update(round_ms=round(ms, 2), train_loss=round(h["Train/Loss"], 5),
                   test_acc=round(h["Test/Acc"], 4))
    if not all(np.isfinite(h["Train/Loss"]) and np.isfinite(h["Test/Loss"]) for h in hist):
        raise RuntimeError(f"turboaggregate: {hist}")
    # the bytes copied each way in a round (the same sizes every round)
    out = {"params": last["params"], "threshold": api.agg.t, "limit": limit,
           **api.transfers, "rounds": rounds}
    log(f"turboaggregate ({TA_GROUPS} groups, frac_bits {TA_FRAC_BITS}): {json.dumps(out)}")
    return out


def run_decentralized() -> dict:
    """Phase 13 (e), cell 31: DSGD on the symmetric ring and push-sum on
    the asymmetric one at the JAX main's defaults; one fully-connected step
    is the exact node average."""
    import numpy as np
    import torch

    from fedml_tpu_torch import ClassificationTrainer, DecentralizedFLAPI, FedConfig, create_model
    from fedml_tpu_torch.core import topology
    from fedml_tpu_torch.experiments.main_decentralized import make_stream

    x, y = make_stream(DEC_NODES, DEC_ITERATIONS, DEC_DIM, SEED)

    def trainer():
        return ClassificationTrainer(create_model("lr", output_dim=2, input_shape=(DEC_DIM,)))

    topologies = {
        "dsgd": (topology.SymmetricTopologyManager(DEC_NODES, DEC_NEIGHBORS), False),
        "pushsum": (topology.AsymmetricTopologyManager(
            DEC_NODES, DEC_NEIGHBORS, DEC_NEIGHBORS, np.random.RandomState(SEED)), True)}
    out = {}
    for mode, (topo, push_sum) in topologies.items():
        api = DecentralizedFLAPI(trainer(), FedConfig(lr=DEC_LR, seed=SEED), topo,
                                 push_sum=push_sum, device="cuda")
        t0 = time.perf_counter()
        z = api.run(x, y)
        seconds = time.perf_counter() - t0
        first, last = np.mean(api.loss_history[:5]), np.mean(api.loss_history[-5:])
        spread = float(z["linear.weight"].std(0, unbiased=False).max())
        if not last < first:
            raise RuntimeError(f"{mode}: the online loss did not fall ({first} -> {last})")
        if mode == "dsgd" and not spread < 0.05:
            raise RuntimeError(f"dsgd: consensus spread {spread}")
        out[mode] = {"seconds": round(seconds, 3), "first5": round(float(first), 5),
                     "last5": round(float(last), 5), "regret": round(api.regret(), 5),
                     "spread": round(spread, 5)}
    fc = DecentralizedFLAPI(trainer(), FedConfig(lr=0.0, seed=SEED),
                            topology.FullyConnectedTopologyManager(DEC_NODES), device="cuda")
    z = fc.init_nodes()
    batch = {"x": torch.zeros(DEC_NODES, 1, DEC_DIM, device=fc.device),
             "y": torch.zeros(DEC_NODES, 1, dtype=torch.int32, device=fc.device),
             "mask": torch.ones(DEC_NODES, 1, device=fc.device)}
    _, _, z_new, _ = fc.step(dict(z), torch.ones(DEC_NODES, device=fc.device), z, batch,
                             fc.W, torch.Generator().manual_seed(SEED))
    fc_gap = max((z_new[k] - v.mean(0, keepdim=True)).abs().max().item() for k, v in z.items())
    if not fc_gap < 1e-6:
        raise RuntimeError(f"a fully-connected step is {fc_gap} from the node average")
    out["fully_connected_gap"] = fc_gap
    log(f"decentralized ({DEC_NODES} nodes, {DEC_ITERATIONS} iterations, dim {DEC_DIM}): "
        f"{json.dumps(out)}")
    return out


#: phase 13 (f): each newly ported launcher name, 1 round from a YAML
LAUNCH_ALGORITHMS = {
    "base": {"comm_round": 1},
    "hierarchical": {"dataset": "mnist", "model": "lr", "partition_method": "homo",
                     "client_num_in_total": 4, "client_num_per_round": 4, "comm_round": 1,
                     "batch_size": 16, "lr": 0.1, "group_num": 2, "group_comm_round": 2},
    "decentralized": {"client_number": DEC_NODES, "iterations": 20},
    "turboaggregate": {"dataset": "mnist", "model": "lr", "partition_method": "homo",
                       "client_num_in_total": 4, "client_num_per_round": 4, "comm_round": 1,
                       "batch_size": 32, "lr": 0.1, "num_groups": 2},
}


def run_base_and_launcher() -> dict:
    """Phase 13 (f): ``main_base``'s defaults give exactly [6, 10, 14]; each
    of the four names runs through ``fed_launch`` from a YAML."""
    import math

    from fedml_tpu_torch.experiments import fed_launch, main_base

    got = main_base.main([])
    if got != [6.0, 10.0, 14.0]:
        raise RuntimeError(f"main_base's defaults gave {got}")
    out = {"main_base": got}
    with tempfile.TemporaryDirectory() as tmp:
        for name, args in LAUNCH_ALGORITHMS.items():
            if name != "base":  # main_base writes no run files
                args = {**args, "run_dir": f"{tmp}/{name}"}
            path = f"{tmp}/{name}.yaml"
            with open(path, "w") as f:
                f.write(f"algorithm: {name}\nargs:\n"
                        + "".join(f"  {k}: {v}\n" for k, v in args.items()))
            t0 = time.perf_counter()
            result = fed_launch.main(["--config", path])
            seconds = time.perf_counter() - t0
            # base and decentralized return floats, the others history records
            last = result[-1] if name in ("base", "decentralized") else result[-1]["Test/Loss"]
            if len(result) != args.get("iterations", 1) or not math.isfinite(last):
                raise RuntimeError(f"fed_launch {name}: {result}")
            out[name] = {"seconds": round(seconds, 2), "last": last}
    log(f"the four launcher names: {json.dumps(out)}")
    return out


def run_algorithms(ds, fused_launches: dict, flash_launches: dict) -> dict:
    """Phase 13: hierarchical, centralized, TurboAggregate, decentralized and
    the base framework (cells 28-31; see the module docstring), every
    path's kernel launches counted."""
    import torch

    started = time.perf_counter()
    log(f"phase 13 cuts: {json.dumps(PHASE13_CUTS)}")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        def path(tag, fn):
            return dataset_path(tag, fused_launches, flash_launches, fn)

        out["hierarchical"] = path("hierarchical", lambda: run_hierarchical(ds))
        out["ci_oracles"] = path("ci oracles", run_ci_oracles)
        out["centralized"] = path("centralized", lambda: run_centralized(ds))
        out["turboaggregate"] = path("turboaggregate", lambda: run_turboaggregate(ds))
        out["decentralized"] = path("decentralized", run_decentralized)
        out["launcher"] = path("base and launcher", run_base_and_launcher)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize()
    seconds = time.perf_counter() - started
    if seconds > PHASE13_BUDGET_S:
        log(f"WARNING phase 13 took {seconds:.1f} s, over its {PHASE13_BUDGET_S:.0f} s "
            f"budget")
    out["seconds"] = round(seconds, 1)
    log(f"phase 13: {seconds:.1f} s")
    return out


# ---- phase 14: FedML's split-learning family (cells 32-34)


def gkt_main(run_dir: str, rounds: int, ckpt_dir=None, flags=GKT_FLAGS):
    """``main_fedgkt.main`` on ``flags`` for ``rounds`` rounds, each phase
    timed (``time_gkt.PhaseTimes``): (the API it ran, its history, the
    phase times)."""
    from fedml_tpu_torch.experiments import main_fedgkt
    from fedml_tpu_torch.experiments.time_gkt import PhaseTimes

    argv = flags + ["--comm_round", str(rounds), "--run_dir", run_dir]
    if ckpt_dir:
        argv += ["--ckpt_dir", ckpt_dir]
    with PhaseTimes() as times:
        hist = main_fedgkt.main(argv)
    return times.apis[-1], hist, times


def run_fedgkt() -> dict:
    """Phase 14 (a), cell 32: FedGKT through ``main_fedgkt`` at full width
    (the ResNet-8 edge, the (5, 6, 6) ResNet-55 server) on the capped
    CIFAR-10 surrogate, GKT_ROUNDS rounds; then a 1 + 1 resumed run, bit for
    bit the straight one."""
    import math

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        api, hist, times = gkt_main(f"{tmp}/straight", GKT_ROUNDS)
        wall = time.perf_counter() - t0
        losses = api.server_loss_history
        if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
            raise RuntimeError(f"fedgkt: server epoch losses {losses}")
        if len(hist) != GKT_ROUNDS or not all(0.0 <= h["Test/Acc"] <= 1.0 for h in hist):
            raise RuntimeError(f"fedgkt: history {hist}")
        if (api.server_module.num_blocks != sum(GKT_SERVER_LAYERS)
                or api.client_module.num_blocks != 1):
            raise RuntimeError("fedgkt: the models are not at full width")
        t1 = time.perf_counter()
        gkt_main(f"{tmp}/first", 1, ckpt_dir=f"{tmp}/ckpt")
        resumed, _, _ = gkt_main(f"{tmp}/resumed", GKT_ROUNDS, ckpt_dir=f"{tmp}/ckpt")
        resume_s = time.perf_counter() - t1
        same_bits("fedgkt 1 + 1 resumed", resumed._ckpt_tree(), api._ckpt_tree())
        if resumed.server_loss_history != losses:
            raise RuntimeError("fedgkt: the resumed run's server losses differ")
    out = {"clients": api.dataset.client_num, "rows": int(api.dataset.train.counts.sum()),
           "n_max": api.dataset.train.n_max, "wall_s": round(wall, 2),
           "client_phase_s": [round(v, 3) for v in times.client_s],
           "server_phase_s": [round(v, 3) for v in times.server_s],
           "feature_bytes": times.feature_bytes, "server_epoch_losses": losses,
           "test_acc": [h["Test/Acc"] for h in hist], "resume_s": round(resume_s, 2),
           "resume": "bit for bit"}
    log(f"fedgkt (ResNet-8 edge, ResNet-55 server, {GKT_CLIENTS} clients capped at "
        f"{GKT_CAP}): {json.dumps(out)}")
    return out


def run_splitnn() -> dict:
    """Phase 14 (b), cell 33: SplitNN through ``main_split_nn`` at width 16
    on the CIFAR-10 surrogate, SPLIT_CYCLES relay cycles, each timed."""
    import math

    import torch

    from fedml_tpu_torch.algorithms.splitnn import SplitNNAPI
    from fedml_tpu_torch.experiments import main_split_nn

    cycle = SplitNNAPI.relay_cycle
    seconds, apis = [], []

    def timed(api, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cycle(api, *args)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        apis.append(api)
        return out

    SplitNNAPI.relay_cycle = timed
    final = {}
    evaluate = SplitNNAPI.evaluate

    def evaluated(api):
        final.update(evaluate(api))
        return final

    SplitNNAPI.evaluate = evaluated
    try:
        with tempfile.TemporaryDirectory() as tmp:
            hist = main_split_nn.main([
                "--dataset", "cifar10", "--partition_method", "hetero",
                "--client_num_in_total", str(SPLIT_CLIENTS), "--client_num_per_round",
                str(SPLIT_CLIENTS), "--batch_size", "32", "--epochs", "1", "--comm_round",
                str(SPLIT_CYCLES), "--split_width", "16", "--lr", str(SPLIT_LR),
                "--seed", str(SEED),
                "--run_dir", tmp])
    finally:
        SplitNNAPI.relay_cycle, SplitNNAPI.evaluate = cycle, evaluate
    numbers = [h["Train/Acc"] for h in hist] + [h["Train/Loss"] for h in hist]
    if len(hist) != SPLIT_CYCLES or not all(math.isfinite(v) for v in numbers) or not (
            0.0 <= final.get("Test/Acc", -1.0) <= 1.0):
        raise RuntimeError(f"split_nn: {hist} {final}")
    api = apis[-1]
    out = {"clients": api.dataset.client_num, "rows": int(api.dataset.train.counts.sum()),
           "n_max": api.dataset.train.n_max, "cycle_s": [round(v, 3) for v in seconds],
           "train_acc": [h["Train/Acc"] for h in hist],
           "train_loss": [h["Train/Loss"] for h in hist], "test_acc": final["Test/Acc"]}
    log(f"split_nn (width 16, {SPLIT_CLIENTS} clients, batch 32): {json.dumps(out)}")
    return out


def run_vfl() -> dict:
    """Phase 14 (c), cell 34: ``main_vfl`` on the lending club surrogate
    with the neural stack (Test/Acc > 0.7, as the JAX package's test holds
    on the CPU) and the linear parties, on NUS-WIDE's with three parties;
    then one NeuralVFLAPI epoch at VFL_ROWS rows of NUS-WIDE's widths,
    timed."""
    import math

    import torch

    from fedml_tpu_torch.algorithms.vfl import NeuralVFLAPI
    from fedml_tpu_torch.data.readers import synthetic_vfl_parties
    from fedml_tpu_torch.experiments import main_vfl

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = {"lending_club dense": ["--dataset", "lending_club", "--model", "dense",
                                       "--epochs", "4", "--batch_size", "64", "--lr", "0.05"],
                "lending_club lr": ["--dataset", "lending_club", "--model", "lr"],
                "nus_wide lr 3 parties": ["--dataset", "nus_wide", "--party_num", "3",
                                          "--model", "lr"]}
        for i, (tag, argv) in enumerate(runs.items()):
            t0 = time.perf_counter()
            got = main_vfl.main(argv + ["--data_dir", f"{tmp}/data", "--run_dir",
                                        f"{tmp}/{i}"])
            if not all(math.isfinite(v) for v in got.values()):
                raise RuntimeError(f"vfl {tag}: {got}")
            out[tag] = {**got, "seconds": round(time.perf_counter() - t0, 3)}
    if not out["lending_club dense"]["Test/Acc"] > 0.7:
        raise RuntimeError(f"vfl: lending_club dense Test/Acc {out['lending_club dense']}")
    t0 = time.perf_counter()
    ptr, ytr, _, _ = synthetic_vfl_parties(VFL_DIMS, n_train=VFL_ROWS, n_test=1, seed=SEED)
    made = time.perf_counter() - t0
    # the API's defaults (hidden 32, lr 0.01, momentum 0.9, wd 0.01): at
    # main_vfl's lr 0.05 the loss spikes to 16.6 within an epoch at these
    # widths (a CPU run at 12,000 rows)
    api = NeuralVFLAPI(list(VFL_DIMS), seed=SEED, device="cuda")
    api.fit([x[:512] for x in ptr], ytr[:512], epochs=1, batch_size=64)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    api.fit(ptr, ytr, epochs=1, batch_size=64, seed=1)  # ends in a host fetch
    seconds = time.perf_counter() - t0
    steps = VFL_ROWS // 64
    losses = api.loss_history[-steps:]
    w = max(1, min(50, steps // 4))  # the windows of the loss check
    first, last = sum(losses[:w]) / w, sum(losses[-w:]) / w
    if not all(math.isfinite(v) for v in losses) or not last < first:
        raise RuntimeError(f"vfl: the timed epoch's loss {first} -> {last}")
    out["neural epoch"] = {"rows": VFL_ROWS, "dims": list(VFL_DIMS),
                           "feature_bytes": sum(x.nbytes for x in ptr),
                           "data_s": round(made, 2), "seconds": round(seconds, 3),
                           "steps": steps, "steps_per_s": round(steps / seconds, 1),
                           f"first{w}_loss": first, f"last{w}_loss": last,
                           "train_acc": api.score(ptr, ytr)}
    log(f"vfl: {json.dumps(out)}")
    return out


#: phase 14 (d): each newly ported launcher name, 1 round or epoch from a YAML
SPLIT_LAUNCH = {
    "fedgkt": {"dataset": "cifar10", "client_num_in_total": 2, "client_num_per_round": 2,
               "comm_round": 1, "batch_size": 64, "client_sample_cap": 64,
               "server_blocks": "[1, 1, 1]", "epochs_server": 1},
    "split_nn": {"dataset": "cifar10", "client_num_in_total": 2, "client_num_per_round": 2,
                 "comm_round": 1, "batch_size": 64, "split_width": 16, "lr": SPLIT_LR},
    "vfl": {"dataset": "lending_club", "model": "dense", "epochs": 1},
}


def run_split_launcher() -> dict:
    """Phase 14 (d): ``fedgkt``, ``split_nn`` and ``vfl`` each run through
    ``fed_launch`` from a YAML; phase 8's control, a ``fednas`` config with
    a ``multihost:`` block, still raises."""
    import math

    from fedml_tpu_torch.experiments import fed_launch

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, args in SPLIT_LAUNCH.items():
            path = f"{tmp}/{name}.yaml"
            with open(path, "w") as f:
                f.write(f"algorithm: {name}\nargs:\n" + "".join(
                    f"  {k}: {v}\n" for k, v in {**args, "run_dir": f"{tmp}/{name}"}.items()))
            t0 = time.perf_counter()
            result = fed_launch.main(["--config", path])
            records = [result] if name == "vfl" else result
            values = [v for r in records for k, v in r.items() if k != "round"]
            if len(records) != 1 or not all(math.isfinite(v) for v in values):
                raise RuntimeError(f"fed_launch {name}: {result}")
            out[name] = {"seconds": round(time.perf_counter() - t0, 2), **records[0]}
        control = write_multihost_control(tmp)
        try:
            fed_launch.main(["--config", control])
        except NotImplementedError:
            out["fednas multihost"] = "raises NotImplementedError"
        else:
            raise RuntimeError("a multihost: block (fednas) did not raise")
    log(f"the split-learning launcher names: {json.dumps(out)}")
    return out


def run_split_family(fused_launches: dict, flash_launches: dict) -> dict:
    """Phase 14: FedGKT, SplitNN and vertical FL (cells 32-34; see the module
    docstring), every path's kernel launches counted."""
    import torch

    started = time.perf_counter()
    log(f"phase 14 cuts: {json.dumps(PHASE14_CUTS)}")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        def path(tag, fn):
            return dataset_path(tag, fused_launches, flash_launches, fn)

        out["fedgkt"] = path("fedgkt", run_fedgkt)
        out["split_nn"] = path("split_nn", run_splitnn)
        out["vfl"] = path("vfl", run_vfl)
        out["launcher"] = path("split-family launcher", run_split_launcher)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize()
    seconds = time.perf_counter() - started
    if seconds > PHASE14_BUDGET_S:
        log(f"WARNING phase 14 took {seconds:.1f} s, over its {PHASE14_BUDGET_S:.0f} s "
            f"budget")
    out["seconds"] = round(seconds, 1)
    log(f"phase 14: {seconds:.1f} s")
    return out


# ---- phase 15: FedNAS and FedSeg (cells 35-36)


def peak_bytes(fn):
    """(fn's result, seconds, peak allocated bytes on the card) of ``fn()``,
    the card synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def nas_dataset():
    from fedml_tpu_torch import load_dataset

    return capped(load_dataset("cifar10", client_num_in_total=NAS_CLIENTS,
                               partition_method="homo", seed=SEED), NAS_CAP)


def nas_api(ds, rounds: int, dtype: str = "float32", **kw):
    from fedml_tpu_torch.algorithms.fednas import FedNASAPI
    from fedml_tpu_torch.core.config import FedConfig

    cfg = FedConfig(client_num_in_total=NAS_CLIENTS, client_num_per_round=NAS_CLIENTS,
                    comm_round=rounds, seed=SEED, dtype=dtype, **NAS_CFG)
    return FedNASAPI(ds, cfg, arch_lr=3e-4, lambda_train=1.0, device="cuda", **NAS_WIDTHS,
                     **kw)


def nas_step(ds, **kw) -> dict:
    """One search step of a batch of client 0's train half and one of its
    val half at the cell's widths (``kw`` picks the mode): seconds, peak
    bytes, loss."""
    import torch

    from fedml_tpu_torch.algorithms.fednas import NASState, draw_gdas_uniforms

    api = nas_api(ds, 1, **kw)
    g = api.global_state
    dev = api.device
    x = torch.from_numpy(ds.train.x[0]).to(dev)
    y = torch.from_numpy(ds.train.y[0]).to(dev)
    b = min(NAS_CFG["batch_size"], NAS_CAP // 2)
    state = NASState(g.params, g.alphas, api._w_opt.init(g.params), api._a_opt.init(g.alphas))
    uniforms = None
    if api.gdas:
        uniforms = draw_gdas_uniforms(torch.Generator().manual_seed(SEED), 1,
                                      api.network.layers, api.network.num_edges)[0].to(dev)
    train = (x[:b], y[:b], torch.ones(b, device=dev))
    val = (x[NAS_CAP // 2:NAS_CAP // 2 + b], y[NAS_CAP // 2:NAS_CAP // 2 + b])
    (_, (loss_n, _, n)), seconds, peak = peak_bytes(
        lambda: api.search_step(state, train, val, api.epoch_lrs[0], True, uniforms))
    loss = float(loss_n / n)
    return {"seconds": round(seconds, 3), "peak_bytes": peak, "loss": loss}


def run_fednas() -> dict:
    """Phase 15 (a), cell 35: FedNAS at DARTS's search widths on the capped
    CIFAR-10 surrogate, NAS_ROUNDS rounds, each timed and evaluated; a
    1 + 1 resumed run, bit for bit the straight one; one first-order, one
    unrolled and one GDAS step; one bfloat16 round."""
    import torch

    ds = nas_dataset()
    per_round = NAS_CLIENTS * (NAS_CAP // 2)
    rounds, evals = [], []
    with tempfile.TemporaryDirectory() as tmp:
        api = nas_api(ds, NAS_ROUNDS)
        net = api.network
        if {k: getattr(net, k) for k in NAS_WIDTHS} != NAS_WIDTHS:
            raise RuntimeError(f"fednas: the search network is not at {NAS_WIDTHS}")
        torch.cuda.reset_peak_memory_stats()
        for r in range(NAS_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = api.train_one_round(r)  # ends in a host fetch of its metrics
            seconds = time.perf_counter() - t0
            api.history.append({"round": r, "search_loss": rec["search_loss"],
                                "search_acc": rec["search_acc"]})
            if rec["search_samples"] != per_round or not all(
                    math.isfinite(rec[k]) for k in ("search_loss", "search_acc")):
                raise RuntimeError(f"fednas round {r}: {rec}")
            rounds.append({"seconds": round(seconds, 3),
                           **{k: rec[k] for k in ("search_loss", "search_acc",
                                                  "search_samples")}})
            t0 = time.perf_counter()
            acc = api.evaluate()["Test/Acc"]
            if not 0.0 <= acc <= 1.0:
                raise RuntimeError(f"fednas round {r}: Test/Acc {acc}")
            evals.append({"Test/Acc": acc, "seconds": round(time.perf_counter() - t0, 3)})
            if r == 0:  # what a 1-round train() leaves in its checkpoint
                api.save_checkpoint(f"{tmp}/ckpt", 1)
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        resumed = nas_api(ds, NAS_ROUNDS)
        resumed.train(ckpt_dir=f"{tmp}/ckpt")  # restores round 1, runs round 2
        resume_s = time.perf_counter() - t0
        same_bits("fednas 1 + 1 resumed", resumed._ckpt_tree(), api._ckpt_tree())
        if (resumed.genotype_history != api.genotype_history
                or resumed.history != api.history):
            raise RuntimeError("fednas: the resumed run's records differ")
    steps = {"first_order": nas_step(ds), "unrolled": nas_step(ds, unrolled=True),
             "gdas": nas_step(ds, gdas=True)}
    if not all(math.isfinite(v["loss"]) for v in steps.values()):
        raise RuntimeError(f"fednas steps: {steps}")
    bf16 = nas_api(ds, 1, dtype="bfloat16")
    if bf16.network.dtype != torch.bfloat16:
        raise RuntimeError("fednas: the bfloat16 network is not in bfloat16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = bf16.train_one_round(0)
    bf16_s = time.perf_counter() - t0
    if not math.isfinite(rec["search_loss"]):
        raise RuntimeError(f"fednas bfloat16 round: {rec}")
    params = sum(p.numel() for p in api.global_state.params.values())
    out = {"clients": NAS_CLIENTS, "rows": int(ds.train.counts.sum()), "params": params,
           "rounds": rounds, "evaluate": evals, "peak_bytes": peak,
           "genotype": str(api.genotype_history[-1]), "resume_s": round(resume_s, 2),
           "resume": "bit for bit", "steps": steps,
           "bfloat16_round": {"seconds": round(bf16_s, 3), "search_loss": rec["search_loss"],
                              "search_acc": rec["search_acc"]}}
    log(f"fednas (DARTS 16 ch, 8 cells, {NAS_CLIENTS} clients capped at {NAS_CAP}): "
        f"{json.dumps(out)}")
    return out


SEG_SCORES = ("Test/accuracy", "Test/accuracy_class", "Test/mIoU", "Test/FWIoU", "Test/loss")


def seg_api(ds, rounds: int, width: int = SEG_WIDTH, dtype: str = "float32"):
    from fedml_tpu_torch.algorithms.fedseg import FedSegAPI
    from fedml_tpu_torch.core.config import FedConfig

    cfg = FedConfig(client_num_in_total=SEG_CLIENTS, client_num_per_round=SEG_CLIENTS,
                    batch_size=SEG_BATCH, lr=SEG_LR, epochs=1, comm_round=rounds, seed=SEED,
                    dtype=dtype, frequency_of_the_test=1, extra={"seg_width": width})
    return FedSegAPI(ds, cfg, device="cuda")


def run_fedseg() -> dict:
    """Phase 15 (b), cell 36: ``main_fedseg`` with DeepLabV3+ at width 32
    on the 64 px pascal_voc surrogate, SEG_ROUNDS rounds, evaluated every
    round; a 1 + 1 FedSegAPI run resumed, bit for bit the straight one; the
    128 px, width-64 rung in float32 and bfloat16."""
    from fedml_tpu_torch import FedAvgAPI, load_dataset
    from fedml_tpu_torch.experiments import main_fedseg

    with tempfile.TemporaryDirectory() as tmp, TimedRounds(FedAvgAPI) as runs:
        hist = main_fedseg.main([
            "--dataset", "pascal_voc", "--model", "deeplab", "--model_width", str(SEG_WIDTH),
            "--image_size", str(SEG_SIDE), "--client_num_in_total", str(SEG_CLIENTS),
            "--client_num_per_round", str(SEG_CLIENTS), "--batch_size", str(SEG_BATCH),
            "--lr", str(SEG_LR), "--comm_round", str(SEG_ROUNDS), "--seed", str(SEED),
            "--data_dir", f"{tmp}/data", "--run_dir", f"{tmp}/run"])
    scores = [{k: h[k] for k in SEG_SCORES} for h in hist]
    if len(hist) != SEG_ROUNDS or not all(math.isfinite(v) for s in scores
                                          for v in s.values()):
        raise RuntimeError(f"fedseg: {hist}")
    ds = load_dataset("pascal_voc", data_dir="/nonexistent", client_num_in_total=SEG_CLIENTS,
                      image_size=SEG_SIDE, seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        straight = seg_api(ds, SEG_ROUNDS)
        shist = straight.train(ckpt_dir=f"{tmp}/straight")  # saves every round
        resume_from(f"{tmp}/straight", f"{tmp}/resumed", 1)
        resumed = seg_api(ds, SEG_ROUNDS)
        rhist = resumed.train(ckpt_dir=f"{tmp}/resumed")
        resume_s = time.perf_counter() - t0
    same_bits("fedseg 1 + 1 resumed", resumed._inner._ckpt_tree(), straight._inner._ckpt_tree())
    if [h["Test/mIoU"] for h in rhist] != [h["Test/mIoU"] for h in shist]:
        raise RuntimeError("fedseg: the resumed run's records differ")
    side, width = SEG_RUNG
    rung_ds = load_dataset("pascal_voc", data_dir="/nonexistent",
                           client_num_in_total=SEG_CLIENTS, image_size=side, seed=SEED)
    rung = {}
    for dtype in ("float32", "bfloat16"):
        with TimedRounds(FedAvgAPI) as timed:
            api = seg_api(rung_ds, 2, width=width, dtype=dtype)
            recs = [api.train_one_round(r) for r in range(2)]
        if not all(math.isfinite(r["loss_sum"]) for r in recs):
            raise RuntimeError(f"fedseg {side} px {dtype}: {recs}")
        rung[dtype] = {"round_ms": [round(v, 1) for v in timed.ms[-1]],
                       "loss_sum": [r["loss_sum"] for r in recs]}
    out = {"clients": SEG_CLIENTS, "rows": int(ds.train.counts.sum()),
           "round_ms": [round(v, 1) for v in runs.ms[-1]], "scores": scores,
           "resume_s": round(resume_s, 2), "resume": "bit for bit",
           f"rung_{side}px_width{width}": rung}
    log(f"fedseg (DeepLabV3+ width {SEG_WIDTH}, {SEG_SIDE} px): {json.dumps(out)}")
    return out


def run_fcn() -> dict:
    """Phase 15 (c): one ``main_fedseg --model fcn --loss_type focal``
    round."""
    from fedml_tpu_torch.experiments import main_fedseg

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        hist = main_fedseg.main(["--model", "fcn", "--loss_type", "focal", "--comm_round", "1",
                                 "--batch_size", str(SEG_BATCH), "--seed", str(SEED),
                                 "--data_dir", f"{tmp}/data", "--run_dir", f"{tmp}/run"])
        seconds = time.perf_counter() - t0
    if len(hist) != 1 or not all(math.isfinite(hist[0][k]) for k in SEG_SCORES):
        raise RuntimeError(f"fcn: {hist}")
    out = {"seconds": round(seconds, 2), **{k: hist[0][k] for k in SEG_SCORES}}
    log(f"fcn (focal): {json.dumps(out)}")
    return out


#: phase 15 (d): the two launcher names, 1 round from a YAML
SEARCH_SEG_LAUNCH = {
    "fednas": {"dataset": "cifar10", "partition_method": "homo", "client_num_in_total": 4,
               "client_num_per_round": 4, "comm_round": 1, "batch_size": 640},
    "fedseg": {"comm_round": 1},
}


def run_search_seg_launcher() -> dict:
    """Phase 15 (d): ``fednas`` and ``fedseg`` each run through
    ``fed_launch`` from a YAML at their mains' widths."""
    from fedml_tpu_torch.experiments import fed_launch

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, args in SEARCH_SEG_LAUNCH.items():
            path = f"{tmp}/{name}.yaml"
            with open(path, "w") as f:
                f.write(f"algorithm: {name}\nargs:\n" + "".join(
                    f"  {k}: {v}\n" for k, v in {**args, "seed": SEED,
                                                 "data_dir": f"{tmp}/data",
                                                 "run_dir": f"{tmp}/{name}"}.items()))
            t0 = time.perf_counter()
            records = fed_launch.main(["--config", path])
            values = [v for r in records for k, v in r.items() if k != "round"]
            if len(records) != 1 or not all(math.isfinite(v) for v in values):
                raise RuntimeError(f"fed_launch {name}: {records}")
            out[name] = {"seconds": round(time.perf_counter() - t0, 2), **records[0]}
    log(f"the search and segmentation launcher names: {json.dumps(out)}")
    return out


def run_search_seg(fused_launches: dict, flash_launches: dict) -> dict:
    """Phase 15: FedNAS and FedSeg (cells 35-36; see the module docstring),
    every path's kernel launches counted."""
    import torch

    started = time.perf_counter()
    log(f"phase 15 cuts: {json.dumps(PHASE15_CUTS)}")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        def path(tag, fn):
            return dataset_path(tag, fused_launches, flash_launches, fn)

        out["fednas"] = path("fednas", run_fednas)
        out["fedseg"] = path("fedseg", run_fedseg)
        out["fcn"] = path("fcn focal", run_fcn)
        out["launcher"] = path("search and segmentation launcher", run_search_seg_launcher)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize()
    seconds = time.perf_counter() - started
    if seconds > PHASE15_BUDGET_S:
        log(f"WARNING phase 15 took {seconds:.1f} s, over its {PHASE15_BUDGET_S:.0f} s "
            f"budget")
    out["seconds"] = round(seconds, 1)
    log(f"phase 15: {seconds:.1f} s")
    return out


# ---- phase 16: the silo-grouped round and FedAvg over MQTT (cells 37-38)


def timed_round(api, round_idx: int, profile: bool = False) -> dict:
    """One round of ``api`` (it ends in its metrics' host fetch): its ms, or
    with ``profile`` its device activity (``profile_zoo.profiled_round``),
    and its train loss."""
    import torch

    from fedml_tpu_torch.experiments import profile_zoo

    if profile:
        prof = profile_zoo.profiled_round(api, round_idx, host_events=False)
        metrics = prof["results"][0]
        out = {"wall_ms": round(prof["wall_ms"], 2), "busy_ms": round(prof["busy_ms"], 2),
               "summed_ms": round(prof["summed_ms"], 2), "streams": prof["streams"],
               "launches": int(prof["launches"]),
               "busy_share": round(prof["busy_ms"] / prof["wall_ms"], 4),
               "top_ms": {name[:80]: round(us / 1e3, 2) for us, _, name in prof["rows"][:5]}}
    else:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = api.train_one_round(round_idx)
        out = {"wall_ms": round((time.perf_counter() - t0) * 1e3, 2)}
    if not all(math.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"round {round_idx}: {metrics}")
    return {**out, "loss": round(metrics["loss_sum"] / max(metrics["total"], 1.0), 5)}


def leaf_gaps(got: dict, want: dict, start: dict) -> tuple:
    """Per leaf ||got - want|| over ``want``'s update from ``start``, the
    update floored at an RMS of LEAF_FLOOR a value, and the same over every
    leaf at once (see LEAF_TOL)."""
    rel, gap_sq, update_sq = {}, 0.0, 0.0
    for k, w in want.items():
        gap = (got[k].double() - w.double()).norm().item()
        update = (w.double() - start[k].double()).norm().item()
        rel[k] = gap / max(update, LEAF_FLOOR * math.sqrt(w.numel()))
        gap_sq += gap * gap
        update_sq += update * update
    return rel, math.sqrt(gap_sq / max(update_sq, 1e-60))


def gap_summary(gaps: tuple, witness: tuple | None = None, top: int = 6) -> dict:
    """Of ``leaf_gaps``: the pooled gap, the largest and the median leaf's,
    the ``top`` leaves of most gap, each with the witness's reading beside
    it, and the witness's own pooled, largest, median and ``top`` leaves,
    each [gap, witness]."""
    rel, pooled = gaps
    worst = sorted(rel, key=rel.get, reverse=True)[:top]
    out = {"leaves": len(rel), "pooled": pooled, "max": rel[worst[0]],
           "median": statistics.median(rel.values()),
           "top": {k: [rel[k]] + ([witness[0][k]] if witness else []) for k in worst}}
    if witness:
        noise, noise_pooled = witness
        noisiest = sorted(noise, key=noise.get, reverse=True)[:top]
        out.update(witness_pooled=noise_pooled, witness_max=noise[noisiest[0]],
                   witness_median=statistics.median(noise.values()),
                   witness_top={k: [rel[k], noise[k]] for k in noisiest})
    return out


def run_silo_grouped() -> dict:
    """Phase 16 (a), cell 37: the silo-grouped round against the engine
    round at the cross-silo config's full width (see the module
    docstring): the two and the rounding witness in lockstep from the same
    globals, the gaps leaf by leaf after each round; the second round of
    the two profiled."""
    import argparse

    import torch

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.experiments import main_fedavg, profile_zoo

    started = t0 = time.perf_counter()
    args = main_fedavg.add_args(argparse.ArgumentParser()).parse_args(
        profile_zoo.FLAGS["cross_silo"] + ["--epochs", "1"])
    cfg, ds, trainer = main_fedavg.setup_run(args)
    ds = capped(ds, SILO_CAP)
    out = {"silos": ds.client_num, "rows": ds.train.counts.tolist(),
           "setup_s": round(time.perf_counter() - t0, 1)}
    threshold, wide_threshold = SILO_THRESHOLDS
    t0 = time.perf_counter()
    engine = FedAvgAPI(ds, cfg, trainer, device="cuda")
    silo = FedAvgAPI(ds, cfg.replace(silo_threshold=threshold), trainer, device="cuda")
    witness = FedAvgAPI(ds, cfg.replace(silo_threshold=threshold), trainer, device="cuda")
    out["apis_s"] = round(time.perf_counter() - t0, 1)
    log(f"cross-silo resnet56 set up: {json.dumps(out)}")
    if "silo" not in silo.round_fn.__qualname__:
        raise RuntimeError("silo_threshold did not route FedAvgAPI to the silo round")
    paths = {"engine": engine, f"silo_{threshold}": silo, "witness": witness}
    rounds = {name: [] for name in paths}
    peaks = {}
    gaps, failed = [], []
    init = {k: v.clone() for k, v in engine.global_variables.items()}
    for r in range(SILO_ROUNDS):
        start = {k: v.clone() for k, v in engine.global_variables.items()}
        silo_start = {k: v.clone() for k, v in silo.global_variables.items()}
        for name, api in paths.items():
            torch.cuda.reset_peak_memory_stats()
            flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
            if api is witness:
                # cuDNN's fastest algorithms by timing, nondeterministic
                # ones among them: other sums of the same products
                torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
            try:
                rounds[name].append(timed_round(
                    api, r, profile=api is not witness and r == SILO_ROUNDS - 1))
            finally:
                torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
            peaks[name] = max(peaks.get(name, 0), torch.cuda.max_memory_allocated())
            rounds[name][-1]["done_s"] = round(time.perf_counter() - started, 1)
        rel, pooled = leaf_gaps(silo.global_variables, engine.global_variables, start)
        gaps.append(gap_summary(
            (rel, pooled), leaf_gaps(witness.global_variables, silo.global_variables,
                                     silo_start)))
        failed += [(r, k, v) for k, v in rel.items() if not v <= LEAF_TOL[r]]
        if not pooled <= POOLED_TOL:
            failed.append((r, "pooled", pooled))
        if r == 0:
            silo_first = {k: v.clone() for k, v in silo.global_variables.items()}
    for name in paths:
        out[name] = {"rounds": rounds[name], "peak_bytes": peaks[name]}
        log(f"cross-silo resnet56, {name} round: {json.dumps(out[name])}")
    out["gaps"] = gaps
    log(f"silo vs engine globals leaf by leaf, [gap, witness] of the leaves of most gap, "
        f"round by round: {json.dumps(gaps)} ({time.perf_counter() - started:.1f} s into "
        "cell 37)")
    if failed:
        raise Disagreement(f"silo round vs engine round over LEAF_TOL {LEAF_TOL} or "
                           f"POOLED_TOL {POOLED_TOL} (round, leaf, gap): {failed[:10]}")
    del engine, silo, witness
    wide = FedAvgAPI(ds, cfg.replace(silo_threshold=wide_threshold), trainer, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    wide_round = timed_round(wide, 0)
    out[f"silo_{wide_threshold}"] = {"rounds": [wide_round],
                                     "peak_bytes": torch.cuda.max_memory_allocated()}
    # two silo lowerings apart after round 0, leaf by leaf
    wide_rel, wide_pooled = leaf_gaps(wide.global_variables, silo_first, init)
    out["wide_gap_max"] = max(wide_rel.values())
    log(f"cross-silo resnet56, silo round at threshold {wide_threshold}: "
        f"{json.dumps(out[f'silo_{wide_threshold}'])}; against threshold {threshold} "
        f"after one round, the largest leaf gap: {out['wide_gap_max']:.3e}")
    if not (out["wide_gap_max"] <= LEAF_TOL[0] and wide_pooled <= POOLED_TOL):
        raise Disagreement(f"silo round at threshold {wide_threshold} vs {threshold}: "
                           f"{gap_summary((wide_rel, wide_pooled))}")
    return out


#: cell 38: main_mqtt_fedavg's flags (FEMNIST CNN_DropOut, the flagship's
#: batch and lr) on the card
MQTT_FLAGS = ["--dataset", "femnist", "--model", "cnn", "--client_num_in_total",
              str(MQTT_CLIENTS), "--client_num_per_round", str(MQTT_WORKERS), "--comm_round",
              str(MQTT_ROUNDS), "--batch_size", "20", "--lr", "0.1", "--seed", str(SEED)]


def wire_probe(payload_bytes: int, reps: int = 3) -> float:
    """Median seconds for one message of ``payload_bytes`` to cross the
    in-process broker on loopback: publish to the subscriber's callback."""
    import threading

    from fedml_tpu_torch.comm import MiniBroker, MqttClient

    broker = MiniBroker()
    try:
        got = threading.Event()
        sub = MqttClient(broker.host, broker.port, "probe_sub")
        sub.subscribe("probe", lambda t, p: got.set())
        pub = MqttClient(broker.host, broker.port, "probe_pub")
        payload, times = b"0" * payload_bytes, []
        for _ in range(reps):
            got.clear()
            t0 = time.perf_counter()
            pub.publish("probe", payload)
            if not got.wait(60):
                raise RuntimeError("the wire probe's message never arrived")
            times.append(time.perf_counter() - t0)
        sub.disconnect()
        pub.disconnect()
    finally:
        broker.close()
    return statistics.median(times)


def run_mqtt_fedavg() -> dict:
    """Phase 16 (b), cell 38: FedAvg over MQTT through ``main_mqtt_fedavg``
    at FEMNIST CNN_DropOut's width (see the module docstring)."""
    import torch

    from fedml_tpu_torch import telemetry
    from fedml_tpu_torch.comm import mqtt_fedavg
    from fedml_tpu_torch.experiments import main_mqtt_fedavg
    from fedml_tpu_torch.telemetry.tracer import Tracer

    server_cls, client_cls = mqtt_fedavg.MqttFedAvgServerManager, mqtt_fedavg.MqttFedAvgClientManager
    sync_round, train_and_reply = server_cls._sync_round, client_cls._train_and_reply
    sent, decoded = {}, {}

    def spy_sync(self, round_idx, msg_type):
        sent[round_idx] = {k: v.clone() for k, v in self.global_variables.items()}
        return sync_round(self, round_idx, msg_type)

    def spy_train(self, msg):
        # the variables this worker decoded, as its local update receives them
        ridx = int(msg.get(mqtt_fedavg.MyMessage.MSG_ARG_KEY_ROUND_IDX))
        inner = self._local_update

        def record(variables, *a, **kw):
            decoded[(self.worker_id, ridx)] = {k: v.clone() for k, v in variables.items()}
            return inner(variables, *a, **kw)

        self._local_update = record
        try:
            return train_and_reply(self, msg)
        finally:
            self._local_update = inner

    started = time.perf_counter()
    tracer = Tracer()
    server_cls._sync_round, client_cls._train_and_reply = spy_sync, spy_train
    telemetry.install(tracer)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            history = main_mqtt_fedavg.main(MQTT_FLAGS + ["--run_dir", tmp, "--data_dir",
                                                          f"{tmp}/data"])
            run_s = time.perf_counter() - t0
    finally:
        telemetry.uninstall(tracer)
        server_cls._sync_round, client_cls._train_and_reply = sync_round, train_and_reply
    losses = [r["test_loss"] for r in history]
    if len(history) != MQTT_ROUNDS or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"mqtt fedavg: {history}")
    want = {(w, r) for w in range(1, MQTT_WORKERS + 1) for r in range(MQTT_ROUNDS)}
    if not want <= set(decoded):
        raise RuntimeError(f"mqtt fedavg: decodes {sorted(decoded)}, wanted {sorted(want)}")
    for (w, r), got in decoded.items():
        for k, v in sent[r].items():
            if got[k].device != v.device or not torch.equal(got[k], v):
                raise Disagreement(f"mqtt fedavg: worker {w} decoded {k} of round {r} "
                                   "unlike the server's")
    params = sum(v.numel() for v in sent[0].values())
    spans: dict = {}
    for sp in tracer.spans:
        spans.setdefault(sp["name"], []).append(sp)
    per_round = {name: round(sum(sp["dur_s"] for sp in spans.get(name, ())) / MQTT_ROUNDS, 3)
                 for name in ("mqtt_encode", "mqtt_publish", "mqtt_decode", "mqtt_train")}
    sizes = sorted({sp["bytes"] for sp in spans.get("mqtt_publish", ())})
    out = {"params": params, "workers": MQTT_WORKERS, "rounds": MQTT_ROUNDS,
           "payload_bytes": sizes, "messages": len(spans.get("mqtt_publish", ())),
           "seconds_a_round": per_round, "run_s": round(run_s, 2),
           "wire_s": round(wire_probe(max(sizes)), 4), "test_loss": losses,
           "cell_s": round(time.perf_counter() - started, 1),
           "test_acc": [r["test_acc"] for r in history],
           "decoded": f"{len(decoded)} worker decodes bit for bit the server's"}
    log(f"fedavg over mqtt (femnist cnn, {MQTT_WORKERS} workers): {json.dumps(out)}")
    return out


def run_silo_mqtt(fused_launches: dict, flash_launches: dict) -> dict:
    """Phase 16: the silo-grouped round and FedAvg over MQTT (cells 37-38;
    see the module docstring), every path's kernel launches counted."""
    import torch

    started = time.perf_counter()
    log(f"phase 16 cuts: {json.dumps(PHASE16_CUTS)}")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        out["silo_grouped"] = dataset_path("cross-silo silo-grouped round", fused_launches,
                                           flash_launches, run_silo_grouped)
        out["mqtt_fedavg"] = dataset_path("fedavg over mqtt", fused_launches, flash_launches,
                                          run_mqtt_fedavg)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize()
    seconds = time.perf_counter() - started
    if seconds > PHASE16_BUDGET_S:
        log(f"WARNING phase 16 took {seconds:.1f} s, over its {PHASE16_BUDGET_S:.0f} s "
            f"budget")
    out["seconds"] = round(seconds, 1)
    log(f"phase 16: {seconds:.1f} s")
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--calibrate", type=int, default=0, metavar="N",
                        help="only print the kernel's agreement readings at the "
                        "flagship shape for seeds 0..N-1, checking nothing")
    parser.add_argument("--launcher-only", action="store_true",
                        help="build the kernels, then run phase 8 alone (the launcher "
                        "over the repo's configs), checking it and printing no result")
    parser.add_argument("--privacy-only", action="store_true",
                        help="build the kernels, then run phase 9 alone (the privacy "
                        "package), checking it and printing no result")
    parser.add_argument("--transport-only", action="store_true",
                        help="build the kernels, then run phase 10 alone (the codecs, "
                        "FedBuff and the superstep), checking it and printing no result")
    parser.add_argument("--datasets-only", action="store_true",
                        help="build the kernels, then run phase 12 alone (stackoverflow_lr, "
                        "LoRA over the LSTMs, the streaming gld23k and ILSVRC2012 paths and "
                        "train-time augmentation), checking it and printing no result")
    parser.add_argument("--algorithms-only", action="store_true",
                        help="build the kernels, then run phase 13 alone (hierarchical, "
                        "centralized, TurboAggregate, decentralized and the base framework), "
                        "checking it and printing no result")
    parser.add_argument("--split-only", action="store_true",
                        help="build the kernels, then run phase 14 alone (FedGKT, SplitNN "
                        "and vertical FL), checking it and printing no result")
    parser.add_argument("--search-seg-only", action="store_true",
                        help="build the kernels, then run phase 15 alone (FedNAS and "
                        "FedSeg), checking it and printing no result")
    parser.add_argument("--silo-mqtt-only", action="store_true",
                        help="build the kernels, then run phase 16 alone (the silo-grouped "
                        "round and FedAvg over MQTT), checking it and printing no result")
    parser.add_argument("--serving-only", action="store_true",
                        help="build the kernels, then run phase 3's NWP path (for its "
                        "launch counts) and phase 11 alone (LoRA, the client ledger, the "
                        "adapter bank and the scheduler), checking it and printing no "
                        "result")
    opts = parser.parse_args(argv)
    calibrate = opts.calibrate
    started = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    try:
        from fedml_tpu_torch.ops import _build, attention, fused_sgd
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    reports = _build.build(["fused_sgd", "flash_attention"])
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(reports) or 'already built'})")
    for name in ("fused_sgd", "flash_attention"):
        # the build keeps each library's ptxas report beside it
        kernels = ptxas_kernels(_build.library_path(name).with_suffix(".ptxas.txt").read_text())
        log(f"  ptxas {name}: {len(kernels)} kernels, max "
            f"{max((x['registers'] for x in kernels.values()), default=0)} registers/thread, "
            f"{sum(x['spill_bytes'] for x in kernels.values())} bytes of spill")
        for line in check_spills(kernels):
            log(f"    {line}")

    # ---- phase 2: kernels vs plain versions, TF32 off for the plain float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if (opts.launcher_only or opts.privacy_only or opts.transport_only or opts.serving_only
            or opts.datasets_only or opts.algorithms_only or opts.split_only
            or opts.search_seg_only or opts.silo_mqtt_only):
        if opts.launcher_only:
            run_launcher({})
        if opts.privacy_only:
            run_privacy({})
        if opts.transport_only:
            from fedml_tpu_torch import load_dataset

            ds = capped(load_dataset("femnist", client_num_in_total=FEMNIST_CLIENTS,
                                     seed=SEED), CAP)
            run_transport(ds, load_nwp(), dev, {}, {})
        if opts.serving_only:
            from fedml_tpu_torch import load_dataset

            ds = capped(load_dataset("femnist", client_num_in_total=FEMNIST_CLIENTS,
                                     seed=SEED), CAP)
            nwp = load_nwp()
            _, reference = with_launches("nwp fedavg", list(attention.launches),
                                         lambda: run_nwp_path(nwp))
            run_serving(ds, nwp, reference, {})
        if opts.datasets_only:
            run_datasets(load_nwp(), {}, {})
        if opts.algorithms_only:
            from fedml_tpu_torch import load_dataset

            run_algorithms(capped(load_dataset("femnist", client_num_in_total=FEMNIST_CLIENTS,
                                               seed=SEED), CAP), {}, {})
        if opts.split_only:
            run_split_family({}, {})
        if opts.search_seg_only:
            run_search_seg({}, {})
        if opts.silo_mqtt_only:
            run_silo_mqtt({}, {})
        log(f"chip_smoke wall time: {time.perf_counter() - started:.1f} s")
        return 0
    if calibrate:
        for seed in range(calibrate):
            for d in ("float32", "bfloat16"):
                for samples in (SAMPLES, FLAGSHIP_SAMPLES):
                    r = compare_fused_epoch(d, dev, CLIENTS, samples, SIDE, CLASSES,
                                            seed, TOL[d]["outliers"], strict=False)[2]
                    log(json.dumps({"dtype": d, "samples": samples, "seed": seed, **r}))
        return 0
    numbers = {d: check_fused_epoch(d, dev) for d in ("float32", "bfloat16")}
    attn = {d: check_attention(d, dev) for d in ("float32", "bfloat16")}
    log(f"flash_fwd on split views under the profiler: {check_one_launch(dev)}")
    log(f"flash_bwd on split views under the profiler: {check_backward_launches(dev)}")

    # ---- phase 3: the main paths through FedAvgAPI
    from fedml_tpu_torch import load_dataset

    t0 = time.perf_counter()
    ds = capped(load_dataset("femnist", client_num_in_total=FEMNIST_CLIENTS, seed=SEED), CAP)
    log(f"femnist surrogate: {FEMNIST_CLIENTS} clients (cut from 3400), capped at "
        f"{CAP} samples, padded width {ds.train.n_max}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    fused_launches, flash_launches = {}, {}
    fused_hist, n = with_launches("femnist fused fedavg", ["fused_epoch"],
                                  lambda: run_main_path(ds, fused=True))
    fused_launches["femnist fused fedavg"] = n["fused_epoch"]
    engine_hist = run_main_path(ds, fused=False)
    for name, hist in (("fused", fused_hist), ("engine", engine_hist)):
        steady = [h["round_time"] * 1e3 for h in hist[1:]]
        log(f"{name} path: median round {statistics.median(steady):.2f} ms over rounds "
            f"1-{len(hist) - 1}, final Test/Acc {hist[-1]['Test/Acc']:.4f}")

    nwp = load_nwp()
    flash = list(attention.launches)
    _, flash_launches["nwp fedavg"] = with_launches("nwp fedavg", flash,
                                                    lambda: run_nwp_path(nwp))

    # ---- phase 4: server rules and client optimizers
    _, flash_launches["nwp fedadam"] = with_launches(
        "nwp fedadam", flash,
        lambda: run_nwp_path(nwp, "fedopt", "nwp fedadam", server_optimizer="adam",
                             server_lr=1e-2, frequency_of_the_test=ROUNDS))
    run_main_path(ds, False, "fednova", tag="engine fednova+momentum+wd+fedprox",
                  comm_round=2, momentum=0.9, wd=1e-4, fedprox_mu=0.01)
    run_main_path(ds, False, tag="engine amsgrad", comm_round=2, client_optimizer="adam",
                  lr=1e-3)
    check_fused_server_rules(ds, fused_launches)

    # ---- phase 5: FedML's benchmark rows beyond FEMNIST (no kernel runs)
    zoo_launches = run_zoo_paths()
    for path, counts in zoo_launches.items():
        fused_launches[path] = counts["fused_epoch"]
        flash_launches[path] = {k: counts[k] for k in flash}

    # ---- phase 6: the drive (pipelined loop, resume, chaos and the guard)
    drive_numbers = run_drives(ds, nwp, fused_launches, flash_launches)

    # ---- phase 7: the flagship at its configured 3400 clients, out of core
    flagship = run_flagship(nwp, dev, fused_launches)

    # ---- phase 8: the launcher over the repo's 26 YAML configs
    launcher = run_launcher(fused_launches)

    # ---- phase 9: the fork's privacy package (no kernel runs)
    privacy_launches: dict = {}
    privacy = run_privacy(privacy_launches)
    for path, counts in privacy_launches.items():
        fused_launches[path] = counts["fused_epoch"]
        flash_launches[path] = {k: counts[k] for k in flash}

    # ---- phase 10: the transport and asynchronous axes (codecs, FedBuff,
    # the superstep) on phase 3's data and configuration
    transport = run_transport(ds, nwp, dev, fused_launches, flash_launches)

    # ---- phase 11: federated LoRA, the client ledger, the adapter bank and
    # the multi-tenant scheduler (cells 20-22)
    serving = run_serving(ds, nwp, flash_launches["nwp fedavg"], flash_launches)

    # ---- phase 12: the FedAvg family's last datasets (cells 23-27; no kernel
    # runs on their paths)
    datasets = run_datasets(nwp, fused_launches, flash_launches)

    # ---- phase 13: the algorithm zoo's first four (cells 28-31; no kernel
    # runs on their paths)
    algorithms = run_algorithms(ds, fused_launches, flash_launches)
    del ds, nwp

    # ---- phase 14: FedML's split-learning family (cells 32-34; no kernel
    # runs on their paths)
    split_family = run_split_family(fused_launches, flash_launches)

    # ---- phase 15: FedNAS and FedSeg (cells 35-36; no kernel runs on
    # their paths)
    search_seg = run_search_seg(fused_launches, flash_launches)

    # ---- phase 16: the silo-grouped round and FedAvg over MQTT (cells
    # 37-38; no kernel runs on their paths)
    silo_mqtt = run_silo_mqtt(fused_launches, flash_launches)
    launches = sum(fused_launches.values())
    attn_launches = {k: sum(p[k] for p in flash_launches.values()) for k in flash}

    f32 = numbers["float32"]
    kernels = [{
        "name": "fused_epoch",
        "route": "cuda",
        "source": "fedml_tpu_torch/csrc/fused_sgd.cu",
        "replaces": "fedml_tpu/ops/fused_sgd.py:461",
        "launches": launches,
        "launches_by_path": fused_launches,
        "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": None,
        # phase 7: the same numbers at the flagship store's padded width
        f"at_{FLAGSHIP_SAMPLES}_rows": flagship["kernel"]["float32"],
        # its kernels on the tensor cores (each on mma.sync, in both types)
        "parts": [f"fused_sgd.cu::{k}" for k in CONV2_KERNELS],
    }]
    replaces = {"flash_fwd": "fedml_tpu/ops/attention.py:142",
                "flash_bwd_dq": "fedml_tpu/ops/attention.py:281",
                "flash_bwd_dkv": "fedml_tpu/ops/attention.py:300"}
    for name, where in replaces.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": "fedml_tpu_torch/csrc/flash_attention.cu",
                        "replaces": where, "launches": attn_launches[name],
                        "launches_by_path": {p: c[name] for p, c in flash_launches.items()},
                        **attn["float32"][name]})
    log(f"bfloat16 fused_epoch: {json.dumps(numbers['bfloat16'])}")
    log(f"bfloat16 flash attention at shape c: {json.dumps(attn['bfloat16'])}")
    log(f"drive depth 0 vs {PIPE_DEPTH}: {json.dumps(drive_numbers)}")
    log(f"bfloat16 fused_epoch at {FLAGSHIP_SAMPLES} rows: "
        f"{json.dumps(flagship['kernel']['bfloat16'])}")
    log(f"flagship {FLAGSHIP_CLIENTS}: "
        f"{json.dumps({k: flagship[k] for k in ('fused', 'engine')})}")
    log(f"launcher: {json.dumps(launcher)}")
    log(f"privacy: {json.dumps(privacy)}")
    log(f"transport: {json.dumps(transport)}")
    log(f"serving: {json.dumps(serving)}")
    log(f"datasets: {json.dumps(datasets)}")
    log(f"algorithms: {json.dumps(algorithms)}")
    log(f"split family: {json.dumps(split_family)}")
    log(f"search and segmentation: {json.dumps(search_seg)}")
    log(f"silo-grouped round and fedavg over mqtt: {json.dumps(silo_mqtt)}")
    log(f"chip_smoke wall time: {time.perf_counter() - started:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
