"""Codecs, wire format, planning and the blocked executors."""
