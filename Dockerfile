# Container parity (SURVEY.md §2 'Container/CI' row). CPU-backend image:
# runs the CLI, tests, and the quickstart; for the GPU, install JAX with its
# CUDA plugin in the deployment environment (chip_smoke.py checks it).
FROM python:3.12-slim
RUN apt-get update && apt-get install -y --no-install-recommends g++ make \
    && rm -rf /var/lib/apt/lists/*
WORKDIR /opt/desman_tpu
COPY pyproject.toml Makefile README.md ./
COPY native ./native
COPY desman_tpu ./desman_tpu
COPY scripts ./scripts
COPY TestData ./TestData
RUN pip install --no-cache-dir jax numpy scipy pandas pytest && \
    make native && pip install --no-cache-dir -e .
ENTRYPOINT ["desman"]
