"""The plain reference that decides `correct`: DINOv2, Bridge-Lite and the
decoder on the Gemma-2 equations in float32 with TF32 off, the serving
recipes' quantizers, and the bridge's training loss. It imports plain torch
only: nothing of the port, of JAX or of the JAX package."""
