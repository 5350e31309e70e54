"""Training engine of the port: lr schedules, the optimizer, EMA and the
single-device trainer."""
