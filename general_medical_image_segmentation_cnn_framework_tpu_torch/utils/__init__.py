"""Offline tools of the port: frequency-domain filters, the prediction
renamer and the MHD -> NIfTI converter, each its own copy of the JAX
package's module of the same name (numpy/scipy and the port's
``data/io.py``)."""
