"""The port's gateway package: so far only the typed wire errors of
``tenancy`` that every staging client maps replies through."""
