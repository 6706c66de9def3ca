"""Drivers of traffic mixes, one module per ``driver`` kind a mix names."""
