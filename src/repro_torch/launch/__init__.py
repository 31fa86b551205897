"""Launchers (port of ``repro/launch``): the device meshes and specs
(:mod:`.mesh`), the training driver with crash recovery (:mod:`.train`)
and the multi-pod dry run (:mod:`.dryrun`)."""
