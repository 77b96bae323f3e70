# Training: the train step, checkpoints, the straggler monitor and the Trainer.
