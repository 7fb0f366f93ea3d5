"""The benchmark harness: cells found by name, set-up, the measured
window, the traced stretches and the correctness check."""
