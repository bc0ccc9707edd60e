"""Blockwise int8 quantize / dequantize: the Migrator's quant cast."""
