"""Operations and bytes of the benchmark's kernels and steps, from shapes.

Each input byte is counted read once and each output byte written once;
where the work depends on the data, what these inputs need (real
nonzeros, not a layout's padding).  ``least_seconds`` turns a count into
the least time an H100 could take (``peaks.py``).
"""
