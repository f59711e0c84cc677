from setuptools import find_packages, setup

setup(
    name="rrmpg-tpu",
    version="0.5.0",
    description=("TPU-native rainfall-runoff modeling framework "
                 "(JAX / XLA / Pallas)"),
    long_description=open("README.md").read(),
    long_description_content_type="text/markdown",
    license="MIT",
    python_requires=">=3.11",
    packages=find_packages(exclude=["tests", "benchmarks"]),
    package_data={
        "rrmpg_tpu.data": ["camels/*.txt"],
        "rrmpg_tpu.native": ["oracle.cpp"],
        "rrmpg_tpu_torch": ["csrc/*.cu"],
    },
    include_package_data=True,
    install_requires=[
        "jax",
        "numpy",
        "pandas",
        "optax",
    ],
    extras_require={
        "plot": ["matplotlib"],
        "test": ["pytest", "scipy"],
        "multihost": ["orbax-checkpoint"],
    },
)
