"""The benchmark's plain reference: the judge of a job's outputs against
what the generator implanted, and the control.  Plain Python and NumPy; it
imports nothing of the program."""
