"""MoGe-2 training of the port: losses, optimizer and schedule builders, and
the train step (``step.make_train_step``)."""
