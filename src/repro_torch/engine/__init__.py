"""The port's execution engine: the training step and its gradient
compression, the serving step and the continuous-batching host loop."""
from repro_torch.engine.compression import (CompressionConfig, compress_grads,
                                            init_error_state)
from repro_torch.engine.serve_step import (ServingEngine, make_serve_step,
                                           sample_token)
from repro_torch.engine.train_step import (TrainConfig, make_eval_step,
                                           make_loss_fn, make_train_step)

__all__ = ["TrainConfig", "make_eval_step", "make_loss_fn",
           "make_train_step", "ServingEngine", "make_serve_step",
           "sample_token", "CompressionConfig", "compress_grads",
           "init_error_state"]
