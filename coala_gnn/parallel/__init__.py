from coala_gnn.parallel.train import TrainState, make_train_step, make_eval_step

__all__ = ["TrainState", "make_train_step", "make_eval_step"]
