"""Core of the port: quantization, the §5.2 cycle model, the tile planner,
ConvCore, the int8 network compiler and the multi-core scheduler."""
