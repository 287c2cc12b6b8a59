"""PyTorch/CUDA port of the PointAcc reproduction.

A second package beside `repro` (the JAX/Pallas reference).  It keeps the
reference's module names and public function names, so each counterpart is
found under the same path:

    repro_torch.core.packed / core.mapping   packed int64 keys; v2 and v1
                                             mapping engines
    repro_torch.core.sparseconv              conv flows + Epilogue
    repro_torch.core.pointops                FPS, kNN, ball query
    repro_torch.core.fusion                  temporal layer fusion planner
    repro_torch.kernels.spconv               hand-written Hopper kernels:
    repro_torch.kernels.fused_mlp              sparse conv, fused MLP chain
    repro_torch.api / core.tensor            PointAccSession, SparseTensor
    repro_torch.models.minkunet              MinkUNet weights + forward
    repro_torch.models.pointnets             PointNet, PointNet++, DGCNN,
                                             F-PointNet++
    repro_torch.models.params                parameter trees, JAX weights
    repro_torch.serve.engine                 PointCloudEngine.segment,
                                             segment_batch
    repro_torch.serve.scheduler              ServeScheduler: bucketed
                                             micro-batches on the card
    repro_torch.serve.faults / overload      typed errors, FaultPlan,
                                             overload control
    repro_torch.obs                          metrics, traces, recorder
    repro_torch.launch.fault_tolerance       PreemptionHandler, Ticker,
                                             Pulse, Heartbeat, StepTimer
    repro_torch.launch.train                 the training launcher (main)
    repro_torch.launch.flops / shapes        the analytic FLOP model
    repro_torch.checkpoint.store             checkpoints in the reference's
                                             format
    repro_torch.configs                      ArchConfig, granite-moe-1b,
                                             qwen1.5-4b / 32b, granite-34b,
                                             mixtral-8x7b, minkunet,
                                             mini-minkunet
    repro_torch.models.layers / moe / lm     LM layers, sorted MoE, LM
    repro_torch.models.registry              build(cfg) -> Model
    repro_torch.kernels.flash_attention      hand-written Hopper kernels:
    repro_torch.kernels.flash_decode           prefill attention, decode
    repro_torch.kernels.grouped_matmul         attention, expert matmul
    repro_torch.serve.lm                     ServeEngine.generate
    repro_torch.train                        losses, AdamW, train step
    repro_torch.data.synthetic / pipeline    scenes, clouds, token batches;
                                             the prefetching iterator

Entry points run on the card.  The CPU is opt-in (`device="cpu"`), where
every kernel wrapper takes its plain PyTorch version.  The package imports
neither `jax` nor anything of `repro`.
"""

from repro_torch.device import configure_precision, resolve_device

__all__ = ["configure_precision", "resolve_device"]
