from repro_torch.train.step import (TrainState, init_train_state, make_loss_fn,
                                    make_train_step)

__all__ = ["TrainState", "init_train_state", "make_loss_fn", "make_train_step"]
