"""Frozen copies of the yardstick: kernel counts and peaks, the inputs'
generators and the profiler arithmetic.  Nothing here imports the program."""
