"""Multi-device execution: an (amp, dp) mesh of torch devices."""
