"""Rendering over several devices and processes, and stereo (counterpart
of the JAX package's ``parallel/``): ``tiles`` splits every pass's sample
slots over a list of devices in one process, ``scene_shard`` also cuts the
triangle table into one row block a device, ``multihost`` runs one process
a rank joined by ``torch.distributed``, ``stereo`` renders two eyes."""
