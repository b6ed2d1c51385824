"""The plain reference of the benchmark's cells, in NumPy.

It follows a sample of an ensemble's lanes through a job's windows
(exact SSA or tau-leaping, each lane's counter-based random stream) and
folds an ensemble's final populations into the record a window reports.
It imports nothing of the program under test: the reaction tables, the
lane keys and every draw are worked out here again from a
configuration's file and the job's seed.
"""
