"""One driver a kind of request, found by the ``op`` of a traffic mix.

``drivers/<op>.py`` defines ``Driver(config, mix, seed, device,
variant="program")``, which makes the op's inputs from the seed and holds
them, and offers:

- ``pick(rng)``: the inputs of the next request, drawn from the seed's stream;
- ``call(key)``: the public call of the system under test, nothing else;
- ``read(key, out, keep)``: the host's read of the result, (ok, the answer
  to keep for the check or None); ``keep`` is the seed's stream that samples
  them, None during warm-up;
- ``check(answers)``: each compared number, by name, from the kept answers
  against the plain reference; the configuration's ``check`` gives each
  its limit;
- ``kind`` ('call' or 'solve'), and ``bytes_per_call`` for calls.

``variant="control"`` puts the control in the program's place: the same
requests in the precision below the one the configuration states, which
the check has to fail.
"""
