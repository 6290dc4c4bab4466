"""Step assembly (the train step and the serve step pair) and the entry
points: training (``train_lm``) and serving (``serve_lm``)."""
