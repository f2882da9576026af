"""The native host runtime: ``native.host``, built at first use."""
