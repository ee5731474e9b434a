from setuptools import find_packages, setup

setup(
    name="localmd_tpu",
    version="0.3.0",
    description="Localized Penalized Matrix Decomposition for functional imaging, in JAX",
    packages=find_packages(exclude=("tests",)),
    python_requires=">=3.10",
    install_requires=[
        "numpy",
        "scipy",
        "jax",
        "jaxlib",
    ],
)
