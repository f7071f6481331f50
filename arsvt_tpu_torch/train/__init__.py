"""Train and eval steps, optimizer, schedules and configs."""
