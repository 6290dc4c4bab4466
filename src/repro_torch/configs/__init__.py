"""Architecture configs (copied data; see :mod:`.registry`)."""
