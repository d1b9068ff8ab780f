"""The port's copy of the front door's prompt-prefix digest contract."""
