"""Launchers: the training driver with crash recovery (port of
``repro/launch``)."""
