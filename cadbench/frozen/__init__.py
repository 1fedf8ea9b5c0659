"""The yardstick's frozen copies: traffic generation, the data-sheet peaks,
the kernel families and bucket rules of a traced window, and the work a
step and its attention kernels need.  The program may change; these may
not."""
