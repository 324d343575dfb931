"""Host utilities: image post-processing, weight conversion from the JAX
package's parameter trees, the tokenizers and the stats exporters."""
