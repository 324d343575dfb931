"""Host utilities: image post-processing and weight conversion from the JAX
package's parameter trees."""
