"""Host-side utilities: filesystem helpers, stage timing."""
