"""Step assembly (the train step and the serve step pair) and the training
entry point."""
