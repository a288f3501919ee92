"""Entry points (port of `repro/launch`): the serving half so far."""
