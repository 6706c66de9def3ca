"""Tile planning: halo-padded tiles bucketed by shape."""
