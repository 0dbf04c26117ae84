"""Training: losses, metrics, schedules, callbacks, and the train, eval
and predict steps."""
