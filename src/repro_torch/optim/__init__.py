"""AdamW with f32 masters, clipping, schedules and EMA."""
