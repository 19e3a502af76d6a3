"""The port's execution engine: the training step and its gradient
compression, the serving step and the continuous-batching host loop, the
two-stage aggregation and distributed joins, pipeline parallelism, and
the dry-run's input specs."""
from repro_torch.engine.aggregation import (broadcast_join,
                                            grad_reduce_two_stage,
                                            hash_partition_join,
                                            segment_preaggregate,
                                            two_stage_aggregate)
from repro_torch.engine.compression import (CompressionConfig, compress_grads,
                                            init_error_state)
from repro_torch.engine.pipeline_parallel import (pipeline_forward,
                                                  pipeline_loss)
from repro_torch.engine.serve_step import (ServingEngine, make_serve_step,
                                           sample_token)
from repro_torch.engine.specs import (abstract_decode_state, input_shardings,
                                      input_specs)
from repro_torch.engine.train_step import (TrainConfig, make_eval_step,
                                           make_grad_fn, make_loss_fn,
                                           make_train_step, shard_batch)

__all__ = ["TrainConfig", "make_eval_step", "make_grad_fn", "make_loss_fn",
           "make_train_step", "shard_batch", "ServingEngine", "make_serve_step",
           "sample_token", "broadcast_join", "grad_reduce_two_stage",
           "hash_partition_join", "segment_preaggregate",
           "two_stage_aggregate", "CompressionConfig", "compress_grads",
           "init_error_state", "pipeline_forward", "pipeline_loss",
           "abstract_decode_state", "input_shardings", "input_specs"]
