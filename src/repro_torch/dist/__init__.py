"""The distributed layer (port of :mod:`repro.dist`): the train and serve
step builders, data-parallel gradient sums with int8 compression, the
elastic policy and drain, and the sharding rules."""
