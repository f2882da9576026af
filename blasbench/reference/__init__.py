"""The plain references that decide ``correct``.

Plain torch in float64 on the run's device, computed in blocks where the
size needs it, from the inputs the benchmark made: nothing here imports
``accblas_tpu_torch`` (or JAX), calls its plain versions, or takes anything
the program derived from the inputs. ``blas`` holds the DOT and the unit
triangular solve, ``cg`` the conjugate-gradient recurrence, ``tf32`` the
rounding of the TF32 control.
"""
