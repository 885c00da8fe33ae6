"""The benchmark's generator: frozen copies of the port's simulator and
writers.  It imports nothing of the program."""
