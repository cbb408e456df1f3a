"""Frozen arithmetic of the benchmark: the card's peaks, the bytes a scan
must move, the operations a train step and the flash kernels must do.
Later changes to the program cannot move these yardsticks."""
