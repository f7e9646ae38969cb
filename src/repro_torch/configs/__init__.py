"""Model configurations and the --arch registry (copies of the JAX
package's pure dataclasses, with the import path changed)."""
