"""The plain reference: a path tracer in plain PyTorch that renders chosen
pixels of chosen frames from the generated meshes, textures and probe. It
imports nothing of the port and takes nothing the port built."""
