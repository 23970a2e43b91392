"""Host tools of the port (numpy, no card): LAS<->H5 conversion,
relabelling, voxel downsampling and dataset statistics, copies of the JAX
package's tools with the imports pointing at the port's own data layer."""
