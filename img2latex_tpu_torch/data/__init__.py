"""Host-side data handling: tokenizer and image canvases."""
