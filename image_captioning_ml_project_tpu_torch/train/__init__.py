"""Training of the port: losses, the optax-exact AdamW and schedules, and
the cross-entropy trainer."""
