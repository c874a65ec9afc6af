"""Host-side driver utilities of the port: logging, stats, timing,
checkpoints, resilience and the watchdog."""
